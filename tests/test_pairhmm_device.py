"""The device pair-HMM (ops/pairhmm_device.py): the plain-JAX wavefront
against the exact f64 reference, grouped packing, the CUDA wrapper's Python
side with the plain-JAX implementation in the kernel's place, the route
and the long-read rule.  Tests marked `gpu` run the CUDA kernel itself and
skip without a card (chip_smoke.py runs them there)."""
import numpy as np
import pytest

import lorikeet_tpu.calling.likelihoods as L
from lorikeet_tpu import device
from lorikeet_tpu.ops import pairhmm_device as D
from lorikeet_tpu.ops.pairhmm import (
    F32_SUSPECT_LOG10, pack_pairhmm_batch, pairhmm_forward_batch,
    pairhmm_forward_np,
)

BASES = np.frombuffer(b"ACGT", np.uint8)


def region_pairs(rng, n_reads, n_haps, rlens, hlen, n_frac=0.0,
                 ambiguous=False):
    """One region's (reads x haplotypes) cross product, sharing the read
    and hap arrays the way production batches do."""
    base = BASES[rng.integers(0, 4, hlen)]
    haps = [base]
    for _ in range(n_haps - 1):
        h = base.copy()
        h[rng.integers(0, hlen, 2)] = BASES[rng.integers(0, 4, 2)]
        haps.append(h)
    if ambiguous:
        haps[-1] = haps[-1].copy()
        haps[-1][rng.integers(0, hlen, 3)] = np.frombuffer(b"NRY", np.uint8)
    pairs = []
    for _ in range(n_reads):
        R = int(rng.choice(rlens))
        lo = int(rng.integers(0, max(1, hlen - R)))
        read = base[lo:lo + R].copy()
        read[rng.integers(0, R, 2)] = BASES[rng.integers(0, 4, 2)]
        if n_frac:
            read[rng.random(R) < n_frac] = ord("N")
        q = rng.integers(6, 41, R).astype(np.uint8)
        iq = rng.integers(20, 46, R).astype(np.uint8)
        dq = rng.integers(20, 46, R).astype(np.uint8)
        gcp = np.full(R, 10, np.uint8)
        pairs += [(h, read, q, iq, dq, gcp) for h in haps]
    return pairs


CASES = {
    "small": dict(n_reads=6, n_haps=3, rlens=range(8, 40), hlen=64),
    "short_reads": dict(n_reads=12, n_haps=4, rlens=range(70, 152),
                        hlen=300),
    "long_reads_multi_bucket": dict(n_reads=5, n_haps=2,
                                    rlens=(200, 300, 420, 512), hlen=560),
    "n_bases": dict(n_reads=8, n_haps=3, rlens=range(40, 90), hlen=160,
                    n_frac=0.05),
    "ambiguity_codes": dict(n_reads=8, n_haps=3, rlens=range(40, 90),
                            hlen=160, ambiguous=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_xla_grouped_matches_f64(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    pairs = region_pairs(rng, **CASES[case])
    got = D.pairhmm_forward_device(pairs, "xla")
    ref = np.array([pairhmm_forward_np(*p) for p in pairs])
    ok = ref > F32_SUSPECT_LOG10
    assert ok.sum() >= len(pairs) // 2
    np.testing.assert_allclose(got[ok], ref[ok], rtol=0, atol=1e-4)


def test_grouped_matches_flat_batch():
    """The grouped layout gives the flat padded batch's values."""
    rng = np.random.default_rng(7)
    pairs = (region_pairs(rng, 5, 3, range(30, 100), 180)
             + region_pairs(rng, 4, 2, range(50, 140), 260))
    grouped = D.pairhmm_forward_device(pairs, "xla")
    flat = np.asarray(pairhmm_forward_batch(**pack_pairhmm_batch(pairs)))
    np.testing.assert_allclose(grouped, flat, rtol=0, atol=1e-4)


@pytest.mark.parametrize("rmax,want", [(1, 32), (32, 32), (33, 64),
                                       (100, 128), (150, 160), (151, 160),
                                       (250, 256), (257, 384), (512, 512)])
def test_read_bucket(rmax, want):
    assert D.read_bucket(rmax) == want
    assert want // 32 in D.ROWS_PER_LANE


def test_read_bucket_rejects_past_limit():
    with pytest.raises(ValueError, match="MAX_READ_LEN"):
        D.read_bucket(D.MAX_READ_LEN + 1)


def test_pack_ships_each_read_and_hap_once():
    rng = np.random.default_rng(1)
    pairs = region_pairs(rng, 9, 4, range(50, 80), 150)
    (reads, rl, haps, hl, pr, ph), n = D.pack_grouped(pairs)
    assert n == len(pairs) == 36
    assert (rl > 0).sum() == 9 and (hl > 0).sum() == 4
    assert reads.shape[1] == 5 and reads.shape[2] == D.read_bucket(79)
    assert haps.shape[1] % 128 == 0
    # every real pair points at its own read and hap row
    for k, (hap, read, q, iq, dq, gcp) in enumerate(pairs):
        r, h = pr[k], ph[k]
        assert rl[r] == len(read) and hl[h] == len(hap)
        np.testing.assert_array_equal(reads[r, 0, :len(read)], read)
        np.testing.assert_array_equal(reads[r, 1, :len(read)], q)
        np.testing.assert_array_equal(reads[r, 4, :len(read)], gcp)
        np.testing.assert_array_equal(haps[h, :len(hap)], hap)


def test_pack_pads_pairs_with_minus_one():
    rng = np.random.default_rng(2)
    pairs = region_pairs(rng, 3, 2, range(20, 30), 60)
    (_, _, _, _, pr, ph), n = D.pack_grouped(pairs)
    assert len(pr) == 256 and n == 6
    assert (pr[n:] == -1).all() and (ph[n:] == -1).all()
    assert (pr[:n] >= 0).all() and (ph[:n] >= 0).all()


@pytest.mark.parametrize("n,floor,want", [(1, 64, 64), (64, 64, 64),
                                          (65, 64, 72), (1000, 256, 1024),
                                          (9972, 256, 10240)])
def test_bucket_pads_at_most_an_eighth(n, floor, want):
    assert D._bucket(n, floor) == want


def test_jobs_split_and_keep_pair_order(monkeypatch):
    monkeypatch.setattr(D, "MAX_PAIRS_PER_DISPATCH", 7)
    rng = np.random.default_rng(3)
    pairs = region_pairs(rng, 6, 3, range(20, 40), 70)
    jobs = D.prepare_jobs(pairs)
    assert [n for _, n in jobs] == [7, 7, 4]
    whole = np.array([pairhmm_forward_np(*p) for p in pairs])
    got = D.readback(D.enqueue_jobs(jobs, "xla"))
    np.testing.assert_allclose(got, whole, rtol=0, atol=1e-4)


def test_dispatches_round_robin_over_devices(monkeypatch):
    import jax
    monkeypatch.setattr(D, "MAX_PAIRS_PER_DISPATCH", 5)
    rng = np.random.default_rng(4)
    pairs = region_pairs(rng, 5, 4, range(20, 40), 70)
    devs = jax.devices()[:4]
    outs = D.enqueue_jobs(D.prepare_jobs(pairs), "xla", devs)
    used = [devs.index(list(o.devices())[0]) for o, _ in outs]
    assert len(outs) == 4 and sorted(used) == [0, 1, 2, 3]
    assert all((b - a) % 4 == 1 for a, b in zip(used, used[1:]))
    # the next call continues the turn instead of restarting at device 0
    nxt = D.enqueue_jobs(D.prepare_jobs(pairs[:5]), "xla", devs)
    assert devs.index(list(nxt[0][0].devices())[0]) == (used[-1] + 1) % 4
    np.testing.assert_allclose(
        D.readback(outs), D.pairhmm_forward_device(pairs, "xla"),
        rtol=0, atol=1e-6)


def test_dedup_pairs_roundtrip():
    """Each shared read and hap is stored once; the indices rebuild every
    pair."""
    rng = np.random.default_rng(5)
    pairs = region_pairs(rng, 4, 3, range(20, 40), 70)
    hap_buf, hap_off, bufs, r_off, hi, ri = D.dedup_pairs(pairs)
    assert len(hap_off) == 3 + 1 and len(r_off) == 4 + 1
    for (hap, *row), h, r in zip(pairs, hi, ri):
        np.testing.assert_array_equal(hap_buf[hap_off[h]:hap_off[h + 1]], hap)
        for buf, x in zip(bufs, row):
            np.testing.assert_array_equal(buf[r_off[r]:r_off[r + 1]], x)


def test_cuda_wrapper_shapes():
    """The FFI call's abstract signature: one f32 per (padded) pair."""
    import jax
    rng = np.random.default_rng(6)
    arrays, _ = D.pack_grouped(region_pairs(rng, 3, 2, range(20, 40), 70))
    out = jax.eval_shape(D._forward_cuda_jit, *arrays)
    assert out.shape == arrays[4].shape and out.dtype == np.float32


def test_cuda_route_python_side_with_plain_jax(monkeypatch):
    """Packing, padding and unscatter around the kernel, with the plain-JAX
    implementation (same signature) in the kernel's place."""
    monkeypatch.setitem(D.IMPLS, "cuda", D.forward_xla)
    monkeypatch.setattr(D, "MAX_PAIRS_PER_DISPATCH", 11)
    rng = np.random.default_rng(8)
    pairs = region_pairs(rng, 7, 3, range(60, 150), 240)
    monkeypatch.setattr(device, "device_impl",
                        lambda platform=None: "cuda")
    got = L.compute_pair_likelihoods(pairs, use_pallas=True)
    ref = np.array([pairhmm_forward_np(*p) for p in pairs])
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def test_long_reads_go_to_host_by_length(monkeypatch):
    rng = np.random.default_rng(9)
    pairs = region_pairs(rng, 3, 2, range(40, 60), 700)
    long_read = pairs[0][0][:D.MAX_READ_LEN + 20].copy()
    q = np.full(len(long_read), 30, np.uint8)
    pairs.append((pairs[0][0], long_read, q, q, q, q))
    seen = []
    orig = L._device_lks
    monkeypatch.setattr(L, "_device_lks",
                        lambda ps: seen.append(len(ps)) or orig(ps))
    monkeypatch.setattr(device, "device_impl",
                        lambda platform=None: "xla")
    before = dict(L.DISPATCH_COUNTS)
    got = L.compute_pair_likelihoods(pairs, use_pallas=True)
    assert seen == [len(pairs) - 1]
    assert L.DISPATCH_COUNTS["long_read_host"] == before["long_read_host"] + 1
    ref = np.array([pairhmm_forward_np(*p) for p in pairs])
    ok = ref > F32_SUSPECT_LOG10
    np.testing.assert_allclose(got[ok], ref[ok], rtol=0, atol=1e-4)
    assert got[-1] == pytest.approx(ref[-1], abs=1e-9)   # exact f64


def test_device_error_raises(monkeypatch):
    """A device failure reaches the caller: no silent host fallback."""
    def broken(*arrays):
        raise RuntimeError("simulated kernel launch failure")
    monkeypatch.setitem(D.IMPLS, "xla", broken)
    monkeypatch.setattr(device, "device_impl",
                        lambda platform=None: "xla")
    rng = np.random.default_rng(10)
    pairs = region_pairs(rng, 2, 2, range(20, 30), 50)
    with pytest.raises(RuntimeError, match="simulated kernel launch"):
        L.compute_pair_likelihoods(pairs, use_pallas=True)


# --- on the card ----------------------------------------------------------

@pytest.mark.gpu
def test_cuda_kernel_matches_f64(gpu):
    rng = np.random.default_rng(11)
    pairs = []
    for rlens, hlen in (((20, 32), 80), ((60, 96), 200), ((100, 128), 300),
                        ((150, 151), 400), ((180, 192), 450),
                        ((250, 256), 500), ((300, 384), 600),
                        ((450, 512), 700)):
        pairs += region_pairs(rng, 6, 3, rlens, hlen)
    got = D.pairhmm_forward_device(pairs, "cuda")
    ref = np.array([pairhmm_forward_np(*p) for p in pairs])
    ok = ref > F32_SUSPECT_LOG10
    assert ok.sum() >= len(pairs) // 2
    np.testing.assert_allclose(got[ok], ref[ok], rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_jax(gpu):
    rng = np.random.default_rng(12)
    pairs = region_pairs(rng, 40, 5, range(70, 152), 400, n_frac=0.01)
    cu = D.pairhmm_forward_device(pairs, "cuda")
    xl = D.pairhmm_forward_device(pairs, "xla")
    ok = xl > F32_SUSPECT_LOG10
    np.testing.assert_allclose(cu[ok], xl[ok], rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_cuda_kernel_skips_pad_pairs(gpu):
    rng = np.random.default_rng(13)
    arrays, n = D.pack_grouped(region_pairs(rng, 3, 2, range(40, 60), 90))
    out = np.asarray(D.forward_cuda(*arrays))
    assert np.all(out[n:] == 0.0) and np.all(out[:n] < 0.0)
