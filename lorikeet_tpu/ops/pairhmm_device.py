"""The device pair-HMM: grouped packing and the two implementations of one
signature.

Production pair batches are regions' (reads x haplotypes) cross products.
The grouped layout ships each read and each haplotype once, plus a pair
table of (read row, hap row) indices:

    reads     [rows, 5, rpad] u8   bases, quals, ins quals, del quals, gcp
    read_lens [rows] i32
    haps      [n_haps, hpad] u8
    hap_lens  [n_haps] i32
    pair_read, pair_hap [n_pairs] i32   (-1 = pad pair)
    -> [n_pairs] f32 log10 likelihoods

Two implementations take these arrays:

- ``"cuda"``: the hand-written Hopper kernel (native/pairhmm_cuda.cu), one
  warp per pair with the DP state in registers, called through jax.ffi.
  It has no interpret mode, so it runs only on the GPU.
- ``"xla"``: the plain-JAX wavefront of ops/pairhmm.py over the gathered
  pairs.  It runs on any backend, and is what the CPU tests drive in the
  kernel's place.

Both keep the f32 numerics contract of ops/pairhmm.py; callers escalate
suspect rows to f64 with pairhmm_forward_checked.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import jax
import jax.numpy as jnp

from lorikeet_tpu.ops.pairhmm import _wavefront

#: rows of the read each lane of a warp holds in the CUDA kernel; the read
#: axis is padded to 32 x one of these (the kernel's instantiations)
ROWS_PER_LANE = (1, 2, 3, 4, 5, 6, 8, 12, 16)
#: longest read the device pair-HMM takes; longer reads run on the host's
#: f64 kernel (calling.likelihoods splits the batch by this length test)
MAX_READ_LEN = 32 * ROWS_PER_LANE[-1]
#: pairs per dispatch: bounds the plain-JAX wavefront's [pairs, rpad] state
MAX_PAIRS_PER_DISPATCH = 1 << 16

_FFI_TARGET = "lorikeet_pairhmm_forward"
#: dispatches launched so far: jobs take devices in turn across calls, so
#: one-dispatch batches still spread over a mesh
_LAUNCHED = itertools.count()


def read_bucket(rmax: int) -> int:
    """Padded read axis for a longest read of ``rmax`` bases: the smallest
    32 x ROWS_PER_LANE[k] that holds it."""
    for k in ROWS_PER_LANE:
        if 32 * k >= rmax:
            return 32 * k
    raise ValueError(f"read of {rmax} bp exceeds MAX_READ_LEN={MAX_READ_LEN}")


def _bucket(n: int, floor: int) -> int:
    """Round ``n`` up to an eighth of its power-of-two octave (at least
    ``floor``): at most 1/8 padding, eight shapes per octave."""
    if n <= floor:
        return floor
    step = max(1, (1 << (int(n).bit_length() - 1)) // 8)
    return -(-int(n) // step) * step


def dedup_pairs(pairs):
    """Deduplicate a (hap, read, q, iq, dq, gcp) pair list by array identity
    (a region's reads and haplotypes are shared across its cross product):
    unique reads' five arrays concatenate into five buffers + one offset
    table, unique haps into one buffer + offsets, plus per-pair (hap, read)
    indices."""
    hap_of, hap_list = {}, []
    read_of, read_list = {}, []
    hi_l, ri_l = [], []
    for hap, read, q, iq, dq, gcp in pairs:
        h = hap_of.get(id(hap))
        if h is None:
            h = hap_of[id(hap)] = len(hap_list)
            hap_list.append(hap)
        r = read_of.get(id(read))
        if r is None:
            r = read_of[id(read)] = len(read_list)
            read_list.append((read, q, iq, dq, gcp))
        hi_l.append(h)
        ri_l.append(r)
    u8z = np.zeros(0, np.uint8)
    hap_off = np.zeros(len(hap_list) + 1, np.int64)
    np.cumsum([len(h) for h in hap_list], out=hap_off[1:])
    hap_buf = np.concatenate(hap_list) if hap_list else u8z
    r_off = np.zeros(len(read_list) + 1, np.int64)
    np.cumsum([len(r[0]) for r in read_list], out=r_off[1:])
    bufs = tuple(
        (np.concatenate([r[j] for r in read_list]) if read_list else u8z)
        for j in range(5))
    return (hap_buf, hap_off, bufs, r_off,
            np.asarray(hi_l, np.int32), np.asarray(ri_l, np.int32))


def _ragged_to_rows(buf, off, n_rows, width):
    """Scatter a concatenated ragged buffer into a zero [n_rows, width]."""
    lens = np.diff(off)
    out = np.zeros((n_rows, width), np.uint8)
    row = np.repeat(np.arange(len(lens)), lens)
    col = np.arange(off[-1]) - np.repeat(off[:-1], lens)
    out[row, col] = buf
    return out


def pack_grouped(pairs):
    """Grouped device arrays for one dispatch (see module docstring), and
    the number of real pairs.  Every axis is padded to a bucket (read axis
    per read_bucket, hap axis to 128, counts to eighths of an octave) so repeated
    batches reuse one compiled shape."""
    hap_buf, hap_off, bufs, r_off, hi, ri = dedup_pairs(pairs)
    n_reads, n_haps, n_pairs = len(r_off) - 1, len(hap_off) - 1, len(pairs)
    read_lens = np.diff(r_off).astype(np.int32)
    hap_lens = np.diff(hap_off).astype(np.int32)
    rpad = read_bucket(int(read_lens.max()))
    hpad = -(-int(hap_lens.max()) // 128) * 128
    rows = _bucket(n_reads, 64)
    hrows = _bucket(n_haps, 16)
    prow = _bucket(n_pairs, 256)
    reads = np.stack([_ragged_to_rows(b, r_off, rows, rpad) for b in bufs],
                     axis=1)
    haps = _ragged_to_rows(hap_buf, hap_off, hrows, hpad)
    rl = np.zeros(rows, np.int32)
    rl[:n_reads] = read_lens
    hl = np.zeros(hrows, np.int32)
    hl[:n_haps] = hap_lens
    pair_read = np.full(prow, -1, np.int32)
    pair_read[:n_pairs] = ri
    pair_hap = np.full(prow, -1, np.int32)
    pair_hap[:n_pairs] = hi
    return (reads, rl, haps, hl, pair_read, pair_hap), n_pairs


@jax.jit
def forward_xla(reads, read_lens, haps, hap_lens, pair_read, pair_hap):
    """The plain-JAX implementation: gather each pair's read and haplotype,
    then run the anti-diagonal wavefront (XLA compiles it as a scan)."""
    r = jnp.maximum(pair_read, 0)
    h = jnp.maximum(pair_hap, 0)
    rd = reads[r]
    out = _wavefront(haps[h], hap_lens[h], rd[:, 0], read_lens[r],
                     rd[:, 1], rd[:, 2], rd[:, 3], rd[:, 4])
    return jnp.where(pair_read >= 0, out, 0.0)


@functools.lru_cache(maxsize=None)
def _register_cuda_target() -> None:
    """Build (first use on this machine) and register the CUDA kernel."""
    from lorikeet_tpu import native
    lib = native.load_cuda("pairhmm_cuda", ["pairhmm_cuda.cu"])
    jax.ffi.register_ffi_target(
        _FFI_TARGET, jax.ffi.pycapsule(lib.LorikeetPairHmmForward),
        platform="CUDA")


@jax.jit
def _forward_cuda_jit(reads, read_lens, haps, hap_lens, pair_read, pair_hap):
    return jax.ffi.ffi_call(
        _FFI_TARGET, jax.ShapeDtypeStruct(pair_read.shape, jnp.float32))(
            reads, read_lens, haps, hap_lens, pair_read, pair_hap)


def forward_cuda(*arrays):
    """The hand-written Hopper kernel (same signature as forward_xla)."""
    _register_cuda_target()
    return _forward_cuda_jit(*arrays)


IMPLS = {"cuda": forward_cuda, "xla": forward_xla}


def prepare_jobs(pairs):
    """Host half: pack a pair list into dispatches of at most
    MAX_PAIRS_PER_DISPATCH pairs, in pair order.  Pool workers run this and
    ship the jobs to the parent's device service."""
    return [pack_grouped(pairs[lo:lo + MAX_PAIRS_PER_DISPATCH])
            for lo in range(0, len(pairs), MAX_PAIRS_PER_DISPATCH)]


def enqueue_jobs(jobs, impl: str, devices=None):
    """Device half: put and launch every job (round-robin over ``devices``
    when given, continuing from the previous call: dispatches are
    independent); no readback."""
    fn = IMPLS[impl]
    outs = []
    for arrays, n in jobs:
        dev = devices[next(_LAUNCHED) % len(devices)] if devices else None
        outs.append((fn(*(jax.device_put(a, dev) for a in arrays)), n))
    return outs


def readback(outs) -> np.ndarray:
    """Per-pair log10 likelihoods (f64) of enqueued jobs, in pair order."""
    if not outs:
        return np.zeros(0)
    return np.concatenate([np.asarray(o)[:n] for o, n in outs]).astype(
        np.float64)


def pairhmm_forward_device(pairs, impl: str, devices=None) -> np.ndarray:
    """Raw f32 device log10 likelihoods for a pair list (not yet checked:
    callers pass them through pairhmm_forward_checked)."""
    return readback(enqueue_jobs(prepare_jobs(pairs), impl, devices))
