"""Sharded device pipeline steps: activity profiling over a position-sharded
mesh with halo exchange.

The reference scales the genome axis by chunking with small overlaps
(haplotype_caller_engine.rs:417,947; band-pass needs only a +/-50bp halo,
band_pass_activity_profile.rs:24-26).  Here (SURVEY §5): shard the position
axis across the mesh, run the per-position ref-vs-any EM locally, exchange
kernel-width halos with jax.lax.ppermute between devices for the band-pass
convolution, and psum the (samples x samples)-style depth reductions.

Every contraction runs at precision HIGHEST: a GPU would otherwise take
float32 products in TF32 (about three decimal digits), and the device chain
is held to the host chain at 2e-3.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

# check_vma=False: the EM scan carries replicated closure constants inside
# the shard, which varying-axis typing would reject
shard_map = functools.partial(jax.shard_map, check_vma=False)
_HIGHEST = jax.lax.Precision.HIGHEST

from lorikeet_tpu.models.activity import gaussian_kernel


def active_probabilities_jax(gls, ploidy: int,
                             snp_heterozygosity=0.001,
                             heterozygosity_stdev=0.01,
                             stand_min_conf=25.0,
                             n_iters: int = 20):
    """jnp version of models.activity.active_probabilities with a fixed
    iteration count (static shapes for jit); converged positions freeze."""
    S, L, G = gls.shape
    # constants stay numpy: they are embedded as literals at lowering time
    np_dtype = np.dtype(gls.dtype)  # traced dtypes are numpy dtypes
    counts = np.stack([np.arange(ploidy, -1, -1),
                       np.arange(0, ploidy + 1)], axis=1).astype(np_dtype)
    import math
    log10_comb = np.array(
        [(math.lgamma(ploidy + 1) - math.lgamma(i + 1)
          - math.lgamma(ploidy - i + 1)) / np.log(10) for i in range(G)],
        np_dtype)
    ref_pseudo = snp_heterozygosity / heterozygosity_stdev ** 2
    prior_pseudo = np.array([ref_pseudo, snp_heterozygosity * ref_pseudo],
                            np_dtype)

    def posteriors(log10_af):
        raw = (log10_comb[None, None, :] + gls
               + jnp.einsum("ga,la->lg", counts, log10_af,
                                precision=_HIGHEST)[None, :, :])
        m = raw.max(axis=2, keepdims=True)
        norm = m + jnp.log10(jnp.sum(10.0 ** (raw - m), axis=2, keepdims=True))
        return raw - norm

    def body(state, _):
        log10_af, allele_counts, active = state
        post = posteriors(log10_af)
        lin = 10.0 ** post
        new_counts = jnp.einsum("slg,ga->la", lin, counts,
                                precision=_HIGHEST)
        diff = jnp.abs(new_counts - allele_counts).max(axis=1)
        upd = active[:, None]
        allele_counts = jnp.where(upd, new_counts, allele_counts)
        pseudo = prior_pseudo[None, :] + allele_counts
        af_new = jnp.log10(pseudo / pseudo.sum(axis=1, keepdims=True))
        log10_af = jnp.where(upd, af_new, log10_af)
        active = active & (diff > 0.01)
        return (log10_af, allele_counts, active), None

    log10_af0 = jnp.full((L, 2), -np.log10(2.0), gls.dtype)
    state0 = (log10_af0, jnp.zeros((L, 2), gls.dtype), jnp.ones(L, bool))
    (log10_af, _, _), _ = jax.lax.scan(body, state0, None, length=n_iters)

    post = posteriors(log10_af)
    log10_p_no_variant = post[:, :, 0].sum(axis=0)
    phred = -10.0 * log10_p_no_variant
    plausible = (log10_p_no_variant + 1e-10) < (stand_min_conf * -0.1)
    emit_ok = phred >= stand_min_conf
    qual_u8 = jnp.clip(jnp.trunc(phred), 0, 255)
    prob = 1.0 - 10.0 ** (qual_u8 / -10.0)
    return jnp.where(plausible & emit_ok, prob, 0.0).astype(jnp.float32)


@functools.lru_cache(maxsize=None)
def _activity_jit(ploidy, snp_het, het_std, conf, prop, n_iters):
    """Single-device jitted activity chain: EM active probabilities ->
    HQ-soft-clip state expansion -> band-pass convolution (the device form
    of models.activity.active_probabilities + band_pass_smooth)."""
    kernel = np.asarray(gaussian_kernel(), np.float32)

    @jax.jit
    def fn(gls, hq_mean):
        probs = active_probabilities_jax(gls, ploidy, snp_het, het_std,
                                         conf, n_iters)
        # barrier: without it XLA fuses the EM scan INTO the 101-tap
        # convolution, recomputing the producer per tap (measured: >550 s
        # first call vs 19 s with the barrier on the virtual CPU mesh)
        probs = jax.lax.optimization_barrier(
            _expand_hq_jax(probs, hq_mean, prop))
        return jnp.convolve(probs, kernel, mode="same",
                            precision=_HIGHEST).astype(jnp.float32)

    return fn


def _expand_hq_jax(probs, hq_mean, prop):
    """Device form of models.activity.expand_hq_softclip_states: each
    HQ-soft-clip position scatters its full prob over +/- n as a
    difference-array boxcar (exact reference state expansion,
    activity_profile.rs:308-339)."""
    from lorikeet_tpu.models.activity import (
        AVERAGE_HQ_SOFTCLIPS_HQ_BASES_THRESHOLD as HQ_T)
    L = probs.shape[0]
    hqm = (hq_mean >= HQ_T) & (probs > 0.0)
    p_sel = jnp.where(hqm, probs, 0.0)
    n = jnp.minimum(hq_mean, float(prop)).astype(jnp.int32)
    idxs = jnp.arange(L)
    lo = jnp.clip(idxs - n, 0, L - 1)
    hi = jnp.clip(idxs + n, 0, L - 1)
    delta = jnp.zeros(L + 1, probs.dtype).at[lo].add(p_sel) \
                                         .at[hi + 1].add(-p_sel)
    # boxcar p then -p cancel exactly in f32, so the cumsum returns to
    # true zero after each expansion window
    return jnp.where(hqm, 0.0, probs) + jnp.cumsum(delta[:-1])


@functools.lru_cache(maxsize=None)
def _activity_sharded(mesh, axis, ploidy, snp_het, het_std, conf, prop,
                      n_iters):
    """Position-sharded version: local EM per shard, halo exchange between
    devices for the band-pass convolution (SURVEY §5 halo design)."""
    kernel = np.asarray(gaussian_kernel(), np.float32)
    # halo covers the conv taps PLUS the HQ-soft-clip expansion reach: a
    # neighbour's HQ position within `prop` bp scatters prob into this
    # shard, so raw probs + hq means are exchanged wide enough to replay
    # the expansion locally
    halo = (len(kernel) - 1) // 2 + int(prop)
    n = mesh.devices.size

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, axis, None), P(axis)), out_specs=P(axis))
    def step(gls, hq_mean):
        probs = active_probabilities_jax(gls, ploidy, snp_het, het_std,
                                         conf, n_iters)
        # barrier: see _activity_jit (EM-into-conv fusion pathology)
        probs = jax.lax.optimization_barrier(probs)

        def exchange(x):
            right = jax.lax.ppermute(
                x[:halo], axis, [(i, (i - 1) % n) for i in range(n)])
            left = jax.lax.ppermute(
                x[-halo:], axis, [(i, (i + 1) % n) for i in range(n)])
            idx = jax.lax.axis_index(axis)
            left = jnp.where(idx == 0, 0.0, left)
            right = jnp.where(idx == n - 1, 0.0, right)
            return jnp.concatenate([left, x, right])

        padded = _expand_hq_jax(exchange(probs), exchange(hq_mean), prop)
        return jnp.convolve(padded, kernel, mode="same", precision=_HIGHEST
                            )[halo:-halo].astype(jnp.float32)

    return jax.jit(step)


def smoothed_activity_device(gls: np.ndarray, hq_mean: np.ndarray,
                             ploidy: int,
                             snp_heterozygosity: float = 0.001,
                             heterozygosity_stdev: float = 0.01,
                             stand_min_conf: float = 25.0,
                             max_prob_propagation: int = 50,
                             n_iters: int = 100) -> np.ndarray:
    """Production device path for HOT LOOPs 1-2's downstream
    (haplotype_caller_engine.rs:1053-1106): the per-position ref-vs-any EM +
    band-pass run on-device (position-sharded over the active mesh when one
    is configured), returning the smoothed [L] profile as numpy.  The
    position axis pads to power-of-two buckets so jit compiles a handful of
    shapes per run."""
    from lorikeet_tpu.parallel.sharding import get_mesh
    S, L, G = gls.shape
    mesh = get_mesh()
    use_mesh = mesh is not None and mesh.devices.size > 1
    unit = (mesh.devices.size * 256) if use_mesh else 1024
    Lpad = max(unit, 1 << int(np.ceil(np.log2(max(L, 2)))))
    Lpad = -(-Lpad // unit) * unit
    g = np.zeros((S, Lpad, G), np.float32)
    g[:, :L] = gls
    h = np.zeros(Lpad, np.float32)
    h[:L] = hq_mean
    key = (ploidy, float(snp_heterozygosity), float(heterozygosity_stdev),
           float(stand_min_conf), int(max_prob_propagation), int(n_iters))
    if use_mesh:
        fn = _activity_sharded(mesh, "data", *key)
    else:
        fn = _activity_jit(*key)
    out = np.asarray(fn(jnp.asarray(g), jnp.asarray(h)))
    return out[:L]


def sharded_activity_step(mesh: Mesh, ploidy: int = 2, axis: str = "data"):
    """Position-sharded activity profiling: local EM + halo exchange +
    band-pass convolution + psum'd per-sample depth totals.

    Returns a jitted fn(gls [S, L, G] f32, depths [S, L] f32)
    -> (smoothed probs [L], depth_totals [S]).
    """
    kernel = np.asarray(gaussian_kernel(), np.float32)
    halo = (len(kernel) - 1) // 2
    n = mesh.devices.size

    @functools.partial(
        shard_map, mesh=mesh,
        in_specs=(P(None, axis, None), P(None, axis)),
        out_specs=(P(axis), P()),
    )
    def step(gls, depths):
        probs = active_probabilities_jax(gls, ploidy)          # [L_local]
        # barrier: see _activity_jit (EM-into-conv fusion pathology)
        probs = jax.lax.optimization_barrier(probs)
        # halo exchange: my left edge goes to my left neighbor's right halo
        left_edge = probs[:halo]
        right_edge = probs[-halo:]
        from_right = jax.lax.ppermute(
            left_edge, axis, [(i, (i - 1) % n) for i in range(n)])
        from_left = jax.lax.ppermute(
            right_edge, axis, [(i, (i + 1) % n) for i in range(n)])
        idx = jax.lax.axis_index(axis)
        # zero the wrapped halos at the genome ends
        from_left = jnp.where(idx == 0, 0.0, from_left)
        from_right = jnp.where(idx == n - 1, 0.0, from_right)
        padded = jnp.concatenate([from_left, probs, from_right])
        smoothed = jnp.convolve(padded, kernel, mode="same",
                                precision=_HIGHEST)[halo:-halo]
        depth_total = jax.lax.psum(depths.sum(axis=1), axis)   # [S]
        return smoothed.astype(jnp.float32), depth_total

    return jax.jit(step)
