"""Likelihood-engine unit tests: PCR repeat model vectorization cross-check
and read quality preparation."""
import numpy as np

from lorikeet_tpu.calling.likelihoods import (
    _pcr_error_cache, _repeat_length_at, prepare_read_for_hmm,
    repeat_lengths_vector,
)
from lorikeet_tpu import device
from lorikeet_tpu.io.bam import BamRecord

BASES = np.frombuffer(b"ACGT", np.uint8)


def test_repeat_lengths_vector_matches_scalar():
    rng = np.random.default_rng(3)
    seqs = [
        np.frombuffer(b"TTCTTCCCC", np.uint8),          # the GATK doc example
        np.frombuffer(b"AAAAAAA", np.uint8),
        np.frombuffer(b"ACGTACGTACGT", np.uint8),
        np.frombuffer(b"AGAGAGAGTTTT", np.uint8),
        np.frombuffer(b"A", np.uint8),
        np.frombuffer(b"AC", np.uint8),
    ]
    for _ in range(12):
        n = int(rng.integers(2, 120))
        # low-entropy sequences maximize repeat structure
        seqs.append(BASES[rng.integers(0, 2, n)])
        seqs.append(BASES[rng.integers(0, 4, n)])
    for seq in seqs:
        vec = repeat_lengths_vector(seq)
        scalar = np.array([_repeat_length_at(seq, i) for i in range(len(seq))])
        assert np.array_equal(vec, scalar), (
            seq.tobytes(), vec.tolist(), scalar.tolist())


def test_pcr_error_cache_values():
    cache = _pcr_error_cache()
    assert cache[0] == 40
    assert cache[100] == 6
    assert all(cache[i] >= cache[i + 1] for i in range(100))


def test_prepare_read_quality_caps():
    n = 40
    seq = BASES[np.random.default_rng(0).integers(0, 4, n)]
    qual = np.full(n, 30, np.uint8)
    qual[5] = 10   # below threshold 18 -> fixed to 6
    rec = BamRecord("r", 0, 0, 0, 25, [("M", n)], seq, qual)
    bases, q, iq, dq, gcp = prepare_read_for_hmm(rec)
    assert q[5] == 6
    assert q[0] == 25          # capped at mapq
    assert (gcp == 10).all()
    # PCR model covers positions 0..n-2 (the reference loop leaves the last
    # base at the default 45)
    assert iq[:-1].max() <= 40 and iq.min() >= 6
    assert iq[-1] == 45


def test_route_follows_backend_and_pins(monkeypatch):
    """use_pallas=None follows lorikeet_tpu.device.pairhmm_route (the CPU
    backend routes to the host kernel); True pins the device pair-HMM (its
    plain-JAX implementation here) with no host fallback; both agree."""
    import lorikeet_tpu.calling.likelihoods as L

    rng = np.random.default_rng(3)
    bases = np.frombuffer(b"ACGT", np.uint8)
    hap = bases[rng.integers(0, 4, 40)]
    read = hap[5:25].copy()
    q = np.full(20, 30, np.uint8)
    pairs = [(hap, read, q, q, q, np.full(20, 10, np.uint8))] * 3

    monkeypatch.setattr(L, "DISPATCH_COUNTS",
                        {"device": 0, "host": 0, "remote": 0,
                         "long_read_host": 0})
    out_auto = L.compute_pair_likelihoods(pairs)
    assert L.DISPATCH_COUNTS["host"] == 1 and L.DISPATCH_COUNTS["device"] == 0
    out_dev = L.compute_pair_likelihoods(pairs, use_pallas=True)
    assert L.DISPATCH_COUNTS["device"] == 1
    out_host = L.compute_pair_likelihoods(pairs, use_pallas=False)
    assert L.DISPATCH_COUNTS["host"] == 2
    np.testing.assert_allclose(out_auto, out_host)
    np.testing.assert_allclose(out_dev, out_host, rtol=0, atol=1e-5)


def test_read_bucket_geometry():
    """The read axis pads to 32 lanes x rows-per-lane of a kernel
    instantiation; reads past MAX_READ_LEN have no bucket."""
    from lorikeet_tpu.ops.pairhmm_device import (
        MAX_READ_LEN, ROWS_PER_LANE, read_bucket,
    )
    assert read_bucket(100) == 128
    assert read_bucket(150) == 160
    assert read_bucket(151) == 160
    assert read_bucket(250) == 256
    for r in (1, 31, 32, 96, 100, 127, 128, 151, 250, 300, MAX_READ_LEN):
        b = read_bucket(r)
        assert b >= r and b % 32 == 0 and b // 32 in ROWS_PER_LANE
    assert MAX_READ_LEN == 32 * max(ROWS_PER_LANE)


def test_repeat_lengths_native_matches_numpy():
    import numpy as np

    from lorikeet_tpu.calling.likelihoods import (
        MAX_REPEAT_LENGTH,
        MAX_STR_UNIT_LENGTH,
        _repeat_lengths_vector_np,
    )
    from lorikeet_tpu.ops.repeats_native import (
        native_available,
        repeat_lengths_native,
    )

    if not native_available():
        import pytest
        pytest.skip("no C++ toolchain")
    rng = np.random.default_rng(5)
    B = np.frombuffer(b"ACGT", np.uint8)
    for trial in range(60):
        n = int(rng.integers(0, 160))
        if trial % 2:
            seq = B[rng.integers(0, 2, n)]     # repeat-rich
        else:
            unit = B[rng.integers(0, 4, int(rng.integers(1, 7)))]
            seq = np.tile(unit, 40)[:n]
        got = repeat_lengths_native(seq, MAX_STR_UNIT_LENGTH, MAX_REPEAT_LENGTH)
        assert np.array_equal(got, _repeat_lengths_vector_np(seq))


def test_pcr_indel_model_knob():
    import numpy as np

    from lorikeet_tpu.calling.likelihoods import (
        PCR_INDEL_MODELS,
        prepare_read_for_hmm,
    )
    from lorikeet_tpu.io.bam import BamRecord

    # homopolymer run: repeat caps must bite, harder for lower rate factors
    seq = np.frombuffer(b"ACGT" + b"A" * 12 + b"CGTC", np.uint8)
    rec = BamRecord(name="r", flag=0, tid=0, pos=100, mapq=60,
                    cigar=[("M", len(seq))], seq=seq,
                    qual=np.full(len(seq), 30, np.uint8))
    by_model = {}
    for name, rate in PCR_INDEL_MODELS.items():
        _, _, iq, dq, _ = prepare_read_for_hmm(rec, pcr_rate_factor=rate)
        by_model[name] = (iq.copy(), dq.copy())
    assert np.all(by_model["none"][0] == 45)       # no adjustment at all
    assert by_model["conservative"][0].min() < 45  # repeat cap applied
    # hostile <= aggressive <= conservative, pointwise
    assert np.all(by_model["hostile"][0] <= by_model["aggressive"][0])
    assert np.all(by_model["aggressive"][0] <= by_model["conservative"][0])
    assert np.all(by_model["hostile"][1] <= by_model["conservative"][1])


def test_adaptive_router_cost_model(monkeypatch):
    """The device-vs-host router picks the cheaper side from the measured
    rates, explores the losing side every 16th batch, and honors the
    LORIKEET_PAIRHMM_ROUTE override."""
    import lorikeet_tpu.calling.likelihoods as L

    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", np.uint8)
    hap = bases[rng.integers(0, 4, 300)]
    read = hap[10:110].copy()
    q = np.full(100, 30, np.uint8)
    pairs = [(hap, read, q, q, q, np.full(100, 10, np.uint8))] * 50

    monkeypatch.setattr(L, "_PERF", {"host_cps": None, "dev_bps": None,
                                     "n_batch": 0})
    monkeypatch.setenv("LORIKEET_PAIRHMM_ROUTE", "auto")
    # no data for either side: host first (to learn), then device
    assert L._route_device(pairs) is False
    L._PERF["host_cps"] = 1e9
    assert L._route_device(pairs) is True       # dev side still unknown

    # a slow device: host 1 Gcells/s (1.5 ms), device 100 kB/s over the
    # batch's ~1.2 kB grouped layout (12 ms) -> host wins
    L._PERF["dev_bps"] = 1e5
    assert L._route_device(pairs) is False
    # a fast device: 16 GB/s against a slow host -> device wins
    L._PERF["host_cps"] = 5e7
    L._PERF["dev_bps"] = 16e9
    assert L._route_device(pairs) is True

    # exploration: the 16th batch flips the decision
    L._PERF["n_batch"] = L._EXPLORE_EVERY - 1
    assert L._route_device(pairs) is False      # flipped from device

    # hard overrides
    monkeypatch.setenv("LORIKEET_PAIRHMM_ROUTE", "host")
    assert L._route_device(pairs) is False
    monkeypatch.setenv("LORIKEET_PAIRHMM_ROUTE", "device")
    assert L._route_device(pairs) is True


def test_router_skips_cold_shape_samples(monkeypatch):
    """A device dispatch that meets its shapes for the first time (build,
    registration, compile) gives the router no rate sample; the next one
    with the same shapes does."""
    import lorikeet_tpu.calling.likelihoods as L

    rng = np.random.default_rng(1)
    bases = np.frombuffer(b"ACGT", np.uint8)
    hap = bases[rng.integers(0, 4, 120)]
    read = hap[10:60].copy()
    q = np.full(50, 30, np.uint8)
    pairs = [(hap, read, q, q, q, np.full(50, 10, np.uint8))] * 4

    monkeypatch.setattr(L, "_PERF", {"host_cps": None, "dev_bps": None,
                                     "n_batch": 0})
    monkeypatch.setattr(L, "_WARM_SHAPES", set())
    monkeypatch.setattr(device, "device_impl",
                        lambda platform=None: "xla")
    L.compute_pair_likelihoods(pairs, use_pallas=True)
    assert L._PERF["dev_bps"] is None and len(L._WARM_SHAPES) == 1
    L.compute_pair_likelihoods(pairs, use_pallas=True)
    assert L._PERF["dev_bps"] > 0 and L._PERF["dev_bps_n"] == 1
    # another implementation is another program: cold again
    monkeypatch.setattr(device, "device_impl",
                        lambda platform=None: "cuda")
    import lorikeet_tpu.ops.pairhmm_device as D
    monkeypatch.setitem(D.IMPLS, "cuda", D.forward_xla)
    L.compute_pair_likelihoods(pairs, use_pallas=True)
    assert L._PERF["dev_bps_n"] == 1 and len(L._WARM_SHAPES) == 2
