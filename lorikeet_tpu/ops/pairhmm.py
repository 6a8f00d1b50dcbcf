"""Pair-HMM forward algorithm — the flagship likelihood kernel.

Computes, per (read, haplotype) pair, the log10 total probability of the read
arising from the haplotype under a base-quality/indel-quality error model
(Durbin Fig 4.1 global-alignment FSA).  Numerics contract defined by the
reference implementation (/root/reference/src/pair_hmm/pair_hmm.rs:503-615 and
pair_hmm_model.rs:126-155):

  states M/I/D over (read_len+1) x (hap_len+1); free deletions on row 0
  (D[0,j] = K/hap_len); transition probs per read row i from phred quals:
     mm = 1 - min(1, eps_ins + eps_del)   (Jacobian-table sum is exact for
                                           integer phreds, so plain sum is used)
     m->i = eps(insQ); m->d = eps(delQ); i->m = d->m = 1 - eps(gcp);
     i->i = d->d = eps(gcp)
  prior[i,j] = 1-eps(q) on base match or either base 'N', else eps(q)/3
  result = log10(sum_j M[end,j] + I[end,j]) - log10(K)

Two implementations:

- :func:`pairhmm_forward_np` — exact float64 host reference (conformance spec,
  validated against GATK golden data tests/resources/pairhmm-testdata.txt).
- :func:`pairhmm_forward_batch` — batched plain-JAX implementation.
  Instead of translating the reference's sequential cell loop (which it itself
  flags as the bottleneck, pair_hmm.rs:569-571), it uses an anti-diagonal
  wavefront with the *lane axis = read position*: on diagonal d, cell (i, d-i)
  depends only on diagonals d-1/d-2, so every lane updates in parallel with
  elementwise ops + static shifts.  Per-read-row transition probs are lane
  constants; haplotype bases stream through a shift register.  float32 with
  per-step renormalisation replaces the reference's 2^1020 float64 initial
  condition; suspect results escalate to float64 on the host
  (:func:`pairhmm_forward_checked`).

The hand-written device kernel (native/pairhmm_cuda.cu, dispatched by
ops/pairhmm_device.py) keeps the same float32 contract.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

TRISTATE_CORRECTION = 3.0
_INITIAL_CONDITION = 2.0 ** 1020
_INITIAL_CONDITION_LOG10 = np.log10(_INITIAL_CONDITION)
_NBASE = ord("N")


# ---------------------------------------------------------------------------
# Host reference implementation (float64, exact)
# ---------------------------------------------------------------------------

def _transition_probs(ins_q: np.ndarray, del_q: np.ndarray, gcp: np.ndarray):
    """Per-read-position transition probabilities, float64.

    Returns (mm, im, mi, ii, md, dd) each of shape [read_len].
    mm uses 1 - min(1, eps_i + eps_d): identical to the reference's
    Jacobian-table path for integer phred scores (pair_hmm_model.rs:63-72,
    table step 1e-4 divides 0.1 exactly).
    """
    eps_i = 10.0 ** (np.asarray(ins_q, np.float64) / -10.0)
    eps_d = 10.0 ** (np.asarray(del_q, np.float64) / -10.0)
    eps_g = 10.0 ** (np.asarray(gcp, np.float64) / -10.0)
    mm = 1.0 - np.minimum(1.0, eps_i + eps_d)
    im = 1.0 - eps_g
    return mm, im, eps_i, eps_g, eps_d, eps_g


def pairhmm_forward_np(
    hap: np.ndarray,
    read: np.ndarray,
    quals: np.ndarray,
    ins_quals: np.ndarray,
    del_quals: np.ndarray,
    gcps: np.ndarray,
    use_tristate: bool = True,
) -> float:
    """Exact float64 forward log10-likelihood for one (hap, read) pair.

    Arrays are uint8: hap/read are ASCII bases, quals are raw phred values.
    """
    hap = np.asarray(hap, np.uint8)
    read = np.asarray(read, np.uint8)
    H = hap.size
    R = read.size
    mm, im, mi, ii, md, dd = _transition_probs(ins_quals, del_quals, gcps)

    eps = 10.0 ** (np.asarray(quals, np.float64) / -10.0)
    match_p = 1.0 - eps
    mis_p = eps / (TRISTATE_CORRECTION if use_tristate else 1.0)
    # prior[i, j] for i in 1..R, j in 1..H
    is_match = (read[:, None] == hap[None, :]) | (read[:, None] == _NBASE) | (hap[None, :] == _NBASE)
    prior = np.where(is_match, match_p[:, None], mis_p[:, None])

    M = np.zeros((R + 1, H + 1))
    I = np.zeros((R + 1, H + 1))
    D = np.zeros((R + 1, H + 1))
    D[0, :] = _INITIAL_CONDITION / H

    from scipy.signal import lfilter

    for i in range(1, R + 1):
        M[i, 1:] = prior[i - 1] * (
            M[i - 1, :-1] * mm[i - 1] + (I[i - 1, :-1] + D[i - 1, :-1]) * im[i - 1]
        )
        I[i, 1:] = M[i - 1, 1:] * mi[i - 1] + I[i - 1, 1:] * ii[i - 1]
        # D[i, j] = M[i, j-1]*md + D[i, j-1]*dd : first-order linear recurrence in j
        drive = M[i, :-1] * md[i - 1]
        D[i, 1:] = lfilter([1.0], [1.0, -dd[i - 1]], drive)

    final = np.sum(M[R, 1:]) + np.sum(I[R, 1:])
    return float(np.log10(final) - _INITIAL_CONDITION_LOG10)


# ---------------------------------------------------------------------------
# Batched device implementation (float32, anti-diagonal wavefront)
# ---------------------------------------------------------------------------

def pairhmm_forward_batch(
    haps,       # [B, Hmax] uint8 bases (pad value arbitrary != 'N')
    hap_lens,   # [B] int32
    reads,      # [B, Rmax] uint8 bases
    read_lens,  # [B] int32
    quals,      # [B, Rmax] uint8 phred base quals
    ins_quals,  # [B, Rmax] uint8
    del_quals,  # [B, Rmax] uint8
    gcps,       # [B, Rmax] uint8
) -> jnp.ndarray:
    """Batched forward log10-likelihoods, shape [B] float32.

    Wavefront over anti-diagonals d = i + j; state vectors are indexed by read
    position i.  See module docstring for the layout argument.
    """
    return _pairhmm_jit(
        jnp.asarray(haps), jnp.asarray(hap_lens), jnp.asarray(reads),
        jnp.asarray(read_lens), jnp.asarray(quals), jnp.asarray(ins_quals),
        jnp.asarray(del_quals), jnp.asarray(gcps))


def _wavefront(haps, hap_lens, reads, read_lens, quals, ins_quals,
               del_quals, gcps):
    """Traceable body of pairhmm_forward_batch (also the plain-JAX device
    implementation in ops.pairhmm_device)."""
    B, Rmax = reads.shape
    Hmax = haps.shape[1]
    f32 = jnp.float32
    lane = jnp.arange(Rmax + 1, dtype=jnp.int32)[None, :]
    # rows past each read's end get zero coefficients: their state stays
    # zero and cannot pin the renormalisation peak
    ok = ((lane >= 1) & (lane <= read_lens[:, None]))

    q = quals.astype(f32)
    eps = jnp.power(10.0, q / -10.0)
    match_p = 1.0 - eps
    mis_p = eps / TRISTATE_CORRECTION

    eps_i = jnp.power(10.0, ins_quals.astype(f32) / -10.0)
    eps_d = jnp.power(10.0, del_quals.astype(f32) / -10.0)
    eps_g = jnp.power(10.0, gcps.astype(f32) / -10.0)
    # [B, Rmax+1] transition prob lane-constants, position 0 unused (boundary row)
    pad1 = lambda x: jnp.where(ok, jnp.pad(x, ((0, 0), (1, 0))), 0.0)
    t_mm = pad1(1.0 - jnp.minimum(1.0, eps_i + eps_d))
    t_im = pad1(1.0 - eps_g)
    t_mi = pad1(eps_i)
    t_ii = pad1(eps_g)
    t_md = pad1(eps_d)
    t_dd = pad1(eps_g)
    p_match = pad1(match_p)
    p_mis = pad1(mis_p)
    read_pad = jnp.pad(reads, ((0, 0), (1, 0)))          # [B, Rmax+1]

    boundary = jnp.broadcast_to(lane == 0, (B, Rmax + 1))
    is_end_row = lane == read_lens[:, None]              # the final read row per pair

    # Initial boundary value: D[0, j] = 1 / hap_len (scale-free; rescaling
    # replaces the reference's 2^1020 prefactor).
    b0 = (1.0 / hap_lens.astype(f32))[:, None]           # [B, 1]

    nsteps = Rmax + Hmax + 1

    def shift(x):  # shift +1 along lane axis: out[i] = x[i-1], out[0] = 0
        return jnp.pad(x, ((0, 0), (1, 0)))[:, :-1]

    def step(carry, xs):
        d, new_hap = xs  # scalar diagonal index, [B] entering hap bases
        # m1/i1/d1 = diagonal d-1, m2/i2/d2 = diagonal d-2, all [B, Rmax+1]
        (m1, i1, d1, m2, i2, d2, hap_diag, bval, acc, log10_scale) = carry

        # Haplotype shift register: lane i holds hap base at j-1 = d-i-1.
        # Entering element for diagonal d at lane 0 is hap[d-1] (streamed in as
        # a scan input — per-step dynamic gathers compile pathologically).
        hap_diag = shift(hap_diag).at[:, 0].set(new_hap)

        base_match = (read_pad == hap_diag) | (read_pad == _NBASE) | (hap_diag == _NBASE)
        prior = jnp.where(base_match, p_match, p_mis)

        m_new = prior * (shift(m2) * t_mm + (shift(i2) + shift(d2)) * t_im)
        i_new = shift(m1) * t_mi + shift(i1) * t_ii
        d_new = m1 * t_md + d1 * t_dd

        # Row-0 boundary: M = I = 0, D = boundary value (valid while j <= Hmax)
        m_new = jnp.where(boundary, 0.0, m_new)
        i_new = jnp.where(boundary, 0.0, i_new)
        d_new = jnp.where(boundary, bval, d_new)

        # Accumulate final-row M+I for valid j = d - read_len in [1, hap_len]
        j_here = d - read_lens  # [B]
        valid = ((j_here >= 1) & (j_here <= hap_lens))[:, None] & is_end_row
        acc = acc + jnp.where(valid, m_new + i_new, 0.0)

        # Renormalise: divide all live state by the diagonal *interior* max to
        # keep f32 in range (replaces INITIAL_CONDITION=2^1020 in f64).  The
        # constant boundary row (D[0,j]=1/H) is excluded: including it pins
        # the scale and flushes deep low-likelihood cells to zero (boundary
        # re-seeds row 1 every diagonal, so the interior max stays within
        # ~1e12 of it and the scaled boundary cannot overflow).
        interior = jnp.maximum(m_new, jnp.maximum(i_new, jnp.where(boundary, 0.0, d_new)))
        peak = jnp.max(interior, axis=1, keepdims=True)
        peak = jnp.maximum(peak, jnp.max(acc, axis=1, keepdims=True))
        scale = jnp.where(peak > 0, peak, 1.0)
        inv = 1.0 / scale
        m_new, i_new, d_new = m_new * inv, i_new * inv, d_new * inv
        m1, i1, d1 = m1 * inv, i1 * inv, d1 * inv
        acc = acc * inv
        bval = bval * inv
        log10_scale = log10_scale + jnp.log10(scale[:, 0])

        return (m_new, i_new, d_new, m1, i1, d1, hap_diag, bval, acc, log10_scale), None

    zeros = jnp.zeros((B, Rmax + 1), f32)
    init_d = jnp.where(boundary, b0, 0.0)  # diagonal d=0 holds only cell (0,0)
    hap_diag0 = jnp.zeros((B, Rmax + 1), jnp.uint8)
    carry0 = (zeros, zeros, init_d, zeros, zeros, zeros,
              hap_diag0, b0, zeros, jnp.zeros((B,), f32))

    ds = jnp.arange(1, nsteps, dtype=jnp.int32)
    # Entering hap base per diagonal: hap[d-1] (clipped; overrun lanes are masked)
    hap_stream = jnp.take_along_axis(
        haps, jnp.clip(ds - 1, 0, Hmax - 1)[None, :].repeat(B, 0), axis=1
    ).T  # [nsteps-1, B]
    carry, _ = jax.lax.scan(step, carry0, (ds, hap_stream))
    acc, log10_scale = carry[8], carry[9]
    total = jnp.sum(acc, axis=1)
    return jnp.log10(jnp.maximum(total, jnp.finfo(f32).tiny)) + log10_scale


_pairhmm_jit = jax.jit(_wavefront)


# Below this log10 the f32 device kernels may have flushed deep DP cells
# (single per-diagonal scale cannot span >38 decades); mirror GKL's
# f32->f64 escalation by recomputing those pairs exactly on the host.
F32_SUSPECT_LOG10 = -28.0
#: device results this process recomputed in f64 (pairs checked, pairs
#: escalated): the share of the device path's work the host redoes
ESCALATIONS = {"checked": 0, "escalated": 0}


def pairhmm_forward_checked(results, pairs):
    """Escalate suspicious f32 results to the exact f64 host path.

    ``results``: np.ndarray [B] from a device kernel; ``pairs``: the packed
    (hap, read, q, iq, dq, gcp) tuples in batch order.  Returns corrected
    array.  The reference's AVX path does the same dance (GKL recomputes in
    double below its f32 underflow threshold).
    """
    results = np.asarray(results, np.float64).copy()
    # log10 likelihoods are strictly <= 0: positives, NaNs, or infs mean
    # the device path returned garbage for those rows (e.g. a predicated
    # pad block aliased by a degenerate input) — recompute them exactly
    suspect = np.nonzero((results <= F32_SUSPECT_LOG10) | (results > 0.0)
                         | ~np.isfinite(results))[0]
    ESCALATIONS["checked"] += results.size
    ESCALATIONS["escalated"] += suspect.size
    if suspect.size:
        # recompute the whole suspect set through the threaded native f64
        # batch kernel; the per-pair numpy DP is the fallback only
        from lorikeet_tpu.ops.pairhmm_native import (
            pairhmm_forward_native_batch,
        )
        sub = [pairs[k] for k in suspect]
        exact = pairhmm_forward_native_batch(sub)
        if exact is None:
            exact = np.array([pairhmm_forward_np(*p) for p in sub])
        results[suspect] = exact
    return results


def pack_pairhmm_batch(pairs, r_pad_to=None, h_pad_to=None):
    """Pack a list of (hap, read, q, iq, dq, gcp) uint8-array tuples into padded
    batch arrays for :func:`pairhmm_forward_batch`.

    Returns dict of arrays.  Pads reads/haps to the max length (optionally
    rounded up to `*_pad_to` multiples for bucketing).
    """
    B = len(pairs)
    Rmax = max(len(p[1]) for p in pairs)
    Hmax = max(len(p[0]) for p in pairs)
    if callable(r_pad_to):
        Rmax = r_pad_to(Rmax)
    elif r_pad_to:
        Rmax = -(-Rmax // r_pad_to) * r_pad_to
    if h_pad_to:
        Hmax = -(-Hmax // h_pad_to) * h_pad_to
    out = {
        "haps": np.zeros((B, Hmax), np.uint8),
        "hap_lens": np.zeros(B, np.int32),
        "reads": np.zeros((B, Rmax), np.uint8),
        "read_lens": np.zeros(B, np.int32),
        "quals": np.zeros((B, Rmax), np.uint8),
        "ins_quals": np.zeros((B, Rmax), np.uint8),
        "del_quals": np.zeros((B, Rmax), np.uint8),
        "gcps": np.zeros((B, Rmax), np.uint8),
    }
    for k, (hap, read, q, iq, dq, gcp) in enumerate(pairs):
        H, R = len(hap), len(read)
        out["haps"][k, :H] = hap
        out["hap_lens"][k] = H
        out["reads"][k, :R] = read
        out["read_lens"][k] = R
        out["quals"][k, :R] = q
        out["ins_quals"][k, :R] = iq
        out["del_quals"][k, :R] = dq
        out["gcps"][k, :R] = gcp
    return out
