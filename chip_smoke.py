"""Smoke test of lorikeet-tpu on an NVIDIA GPU: `call` end to end through
the CLI entry point, with the device pair-HMM checked against the exact
f64 host kernel.

Run from the repository root:

    python chip_smoke.py                 # one card
    python chip_smoke.py --four-cards    # the multi-device path on four

One card, in one process:

1. device: JAX must report a GPU (otherwise exit 2, no result line); the
   card's name and power limit from nvidia-smi.
2. set-up: compile cache, native builds (the CUDA kernel included), a
   warm-up dispatch and a warm-up `call`, then the simulated input: one
   2 Mbp contig, 2 samples x 30x of 150 bp paired reads with planted SNPs
   and indels (testkit.simulate via bench_e2e.simulate_dataset).  Nothing
   downloads.
3. the pytest cases marked `gpu` (tests/test_pairhmm_device.py).
4. `lorikeet_tpu.cli.main(["call", ...])` in four legs: serial with the
   route as a user gets it (the adaptive router, unpinned); serial and
   -t 4 with the pair-HMM pinned to the device (pool workers ship their
   batches to this process's device service); --force-cpu on the host.
5. checks: per-pair |delta| of >= 10,000 device likelihoods against f64,
   identical VCF sites/alleles/genotypes across legs with QUAL within
   QUAL_TOL, recall of the planted variants, and one process on the card.

--four-cards runs only the serial leg with --devices 4 and with --devices 1
and compares their VCFs.  Every phase passes or the script exits non-zero;
the last line of stdout is {"ok": true, "device": {...}}.
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

#: per-pair bound on |device - f64| in log10.  The f32 wavefront keeps the
#: DP state within one power-of-two renormalisation, so its relative error
#: grows like (cells on the path) x 2^-24; over a 150 x 450 matrix that is
#: ~1e-5 in log10, and the earlier f32 device kernel measured 3.3e-5 against
#: the GATK goldens.  1e-3 leaves an order of magnitude above both.  The
#: pair-HMM has no matrix product, so TF32 does not enter; the CUDA kernel
#: is built without fast-math (exp10f, log10f are IEEE-accurate to 2 ulp).
#: Results below F32_SUSPECT_LOG10 are recomputed in f64 before this check.
PAIR_TOL = 1e-3
#: pairs compared against the f64 kernel
MIN_PAIRS = 10_000
#: bound on |QUAL_device - QUAL_host| in phred.  QUAL sums per-read
#: likelihood differences over a site's reads (<= ~150 here); at the
#: measured per-pair error (~1e-5 log10) that moves QUAL by < 0.02 phred;
#: 0.1 is five times that and well under the VCF's own rounding to 0.01
#: of anything a filter reads.
QUAL_TOL = 0.1
#: planted-variant recall every leg must reach on this input
MIN_RECALL = 0.9
#: the input: one MAG-sized contig (kbp), samples, depth, read length, seed
KBP, SAMPLES, COVERAGE, READ_LENGTH, SEED = 2000, 2, 30.0, 150, 0


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def gpu_processes() -> list:
    """Processes holding a context on the card, per nvidia-smi."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [l.strip() for l in out.stdout.splitlines() if l.strip()]


class CompileClock:
    """Seconds XLA spends compiling (jax.monitoring backend-compile
    events), so compile time is reported apart from run time."""

    def __init__(self):
        import jax.monitoring
        self.seconds = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration


def read_vcf(path):
    """[(chrom, pos, ref, alt, qual, (GT, ...))] of a VCF's records."""
    rows = []
    with open(path) as fh:
        for line in fh:
            if line.startswith("#"):
                continue
            f = line.rstrip("\n").split("\t")
            gts = tuple(s.split(":")[0] for s in f[9:])
            rows.append((f[0], int(f[1]), f[3], f[4], float(f[5]), gts))
    return rows


def compare_vcfs(name, rows, ref_rows):
    """Same sites, alleles and genotypes; QUAL within QUAL_TOL."""
    key = lambda r: (r[0], r[1], r[2], r[3], r[5])
    if [key(r) for r in rows] != [key(r) for r in ref_rows]:
        a = {key(r) for r in rows}
        b = {key(r) for r in ref_rows}
        raise AssertionError(
            f"{name}: VCF records differ: {len(a - b)} only here, "
            f"{len(b - a)} only in the reference leg; e.g. "
            f"{sorted(a - b)[:3]} / {sorted(b - a)[:3]}")
    dq = max((abs(r[4] - s[4]) for r, s in zip(rows, ref_rows)),
             default=0.0)
    log(f"vcf {name}: {len(rows)} records identical in sites, alleles and "
        f"genotypes; max |dQUAL| = {dq!r} (bound {QUAL_TOL})")
    assert dq <= QUAL_TOL, f"{name}: QUAL differs by {dq} > {QUAL_TOL}"


def recall(rows, truth) -> float:
    """Planted variants found at their position (indels may left-align up
    to 25 bp upstream), as bench_e2e.recall."""
    called = {r[1] - 1 for r in rows}
    hit = 0
    for t in truth:
        if t.pos in called or (len(t.ref) != len(t.alt) and any(
                p in called for p in range(t.pos - 25, t.pos))):
            hit += 1
    return hit / max(len(truth), 1)


def call_leg(name, argv, clock, dispatch_counts, route="device"):
    """One `lorikeet-tpu call` through cli.main with LORIKEET_PAIRHMM_ROUTE
    set to ``route`` ("auto" leaves it unset, as a user runs it); returns
    (vcf path, wall seconds, compile seconds inside the leg, dispatch
    counts)."""
    from lorikeet_tpu import cli
    from lorikeet_tpu.ops.pairhmm import ESCALATIONS
    for k in dispatch_counts:
        dispatch_counts[k] = 0
    ESCALATIONS.update(checked=0, escalated=0)
    if route == "auto":
        os.environ.pop("LORIKEET_PAIRHMM_ROUTE", None)
    else:
        os.environ["LORIKEET_PAIRHMM_ROUTE"] = route
    c0 = clock.seconds
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    assert rc == 0, f"{name}: cli.main returned {rc}"
    vcf = json.loads(out.getvalue())["outputs"]["vcf"]
    compile_s = clock.seconds - c0
    counts = dict(dispatch_counts)
    log(f"leg {name}: wall {wall!r} s (compile {compile_s!r} s, run "
        f"{wall - compile_s!r} s); DISPATCH_COUNTS {json.dumps(counts)}; "
        f"device results recomputed in f64 {json.dumps(ESCALATIONS)}")
    return vcf, wall, compile_s, counts


class Recorder:
    """Keeps the first pair batches (and their checked device results)
    that compute_pair_likelihoods returns, up to ``cap`` pairs."""

    def __init__(self, module, cap):
        self.module, self.cap = module, cap
        self.batches, self.n = [], 0
        self._orig = module.compute_pair_likelihoods

    def __enter__(self):
        def recording(pairs, use_pallas=None):
            out = self._orig(pairs, use_pallas)
            if self.n < self.cap:
                self.batches.append((pairs, out))
                self.n += len(pairs)
            return out
        self.module.compute_pair_likelihoods = recording
        return self

    def __exit__(self, *exc):
        self.module.compute_pair_likelihoods = self._orig


def check_pairs(batches):
    import numpy as np
    from lorikeet_tpu.ops.pairhmm_native import pairhmm_forward_native_batch
    pairs = [p for b, _ in batches for p in b]
    dev = np.concatenate([o for _, o in batches])
    exact = pairhmm_forward_native_batch(pairs)
    assert exact is not None, "the f64 host kernel did not build"
    d = np.abs(dev - exact)
    log(f"pairs: {len(pairs)} device likelihoods against f64: max |d| = "
        f"{float(d.max())!r}, p99 |d| = {float(np.percentile(d, 99))!r} "
        f"(bound {PAIR_TOL}, log10)")
    assert len(pairs) >= MIN_PAIRS, f"only {len(pairs)} pairs recorded"
    assert float(d.max()) <= PAIR_TOL


def setup(work, clock, kbp=KBP):
    """Compile cache, native builds, a warm-up dispatch and a warm-up
    `call` on a small genome (every native library built, every wrapper
    compiled once), then the data: KBP kbp (a rehearsal may pass less)."""
    import numpy as np
    from lorikeet_tpu import native
    from lorikeet_tpu.device import device_impl, setup_compile_cache
    from lorikeet_tpu.ops.pairhmm_device import pairhmm_forward_device
    from lorikeet_tpu.ops.pairhmm_native import native_available
    from lorikeet_tpu.parallel.sharding import demo_pairs

    t0 = time.perf_counter()
    cache = setup_compile_cache()
    assert native_available(), "the f64 host kernel did not build"
    raw = pairhmm_forward_device(demo_pairs(64), device_impl())
    assert np.all(np.isfinite(raw)) and np.all(raw <= 0)
    log(f"set-up: compile cache {cache}; device pair-HMM "
        f"{device_impl()} ready in {time.perf_counter() - t0!r} s")

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bench_e2e
    t0 = time.perf_counter()
    c0 = clock.seconds
    small = os.path.join(work, "warmup")
    os.makedirs(small)
    fa, bams, _ = bench_e2e.simulate_dataset(
        small, 20, 1, COVERAGE, seed=SEED + 1, cache=False,
        read_length=READ_LENGTH)
    os.environ["LORIKEET_PAIRHMM_ROUTE"] = "device"
    with contextlib.redirect_stdout(io.StringIO()):
        from lorikeet_tpu import cli
        assert cli.main(["call", "-r", fa, "-b", *bams, "-t", "1", "-o",
                         os.path.join(small, "out")]) == 0
    log(f"set-up: warm-up call in {time.perf_counter() - t0!r} s (compile "
        f"{clock.seconds - c0!r} s); native builds "
        f"{json.dumps(native.BUILD_SECONDS)} s")

    t0 = time.perf_counter()
    fasta, bams, truth = bench_e2e.simulate_dataset(
        work, kbp, SAMPLES, COVERAGE, seed=SEED, cache=False,
        read_length=READ_LENGTH)
    log(f"set-up: simulated {kbp} kbp x {SAMPLES} samples x {COVERAGE}x "
        f"of {READ_LENGTH} bp reads, {len(truth)} planted variants, in "
        f"{time.perf_counter() - t0!r} s")
    return fasta, bams, truth


def run_gpu_tests():
    import pytest
    os.environ["LORIKEET_TEST_GPU"] = "1"
    root = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(root, "tests", "test_pairhmm_device.py")])
    assert rc == 0, f"gpu-marked tests failed (pytest exit {rc})"
    log("gpu tests: passed")


def one_card(work, clock, kbp=KBP):
    from lorikeet_tpu.calling import likelihoods as L
    fasta, bams, truth = setup(work, clock, kbp)
    run_gpu_tests()
    base = ["call", "-r", fasta, "-b", *bams, "--force"]
    # the router as a user's plain `call` meets it: it has only the warm-up
    # call's samples, and it may send any batch to either side
    auto, _, _, _ = call_leg(
        "auto", base + ["-t", "1", "-o", os.path.join(work, "auto")], clock,
        L.DISPATCH_COUNTS, route="auto")
    with Recorder(L, cap=200_000) as rec:
        serial, _, _, c_serial = call_leg(
            "serial", base + ["-t", "1", "-o", os.path.join(work, "serial")],
            clock,
            L.DISPATCH_COUNTS)
    assert c_serial["device"] > 0, "serial leg: no pair batch ran on device"
    check_pairs(rec.batches)

    seen = []
    stop = threading.Event()

    def sample():
        while not stop.wait(2.0):
            seen.append(gpu_processes())

    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    try:
        pooled, _, _, c_pool = call_leg(
            "t4", base + ["-t", "4", "-o", os.path.join(work, "t4")], clock,
            L.DISPATCH_COUNTS)
    finally:
        stop.set()
        sampler.join()
    from lorikeet_tpu.parallel.pool import pool_alive, shutdown_pool
    assert pool_alive(), "-t 4 leg ran without the span-worker pool"
    seen.append(gpu_processes())
    shutdown_pool()
    most = max(seen, key=len)
    log(f"gpu processes during -t 4 (nvidia-smi --query-compute-apps, "
        f"{len(seen)} samples, most at once): {most}")
    assert len(most) == 1, "a pool worker holds a context on the card"
    assert c_pool["device"] > 0, "-t 4 leg: the device service ran nothing"

    host, _, _, c_host = call_leg(
        "host", base + ["-t", "1", "--force-cpu", "-o",
                        os.path.join(work, "host")],
        clock, L.DISPATCH_COUNTS)
    assert c_host["device"] == 0

    legs = {"auto": read_vcf(auto), "serial": read_vcf(serial),
            "t4": read_vcf(pooled), "host": read_vcf(host)}
    for name in ("auto", "serial", "t4"):
        compare_vcfs(f"{name} vs host", legs[name], legs["host"])
    for name, rows in legs.items():
        r = recall(rows, truth)
        log(f"recall {name}: {r!r} of {len(truth)} planted variants")
        assert r >= MIN_RECALL, f"{name}: recall {r} < {MIN_RECALL}"


def four_cards(work, clock, kbp=KBP):
    import jax
    from lorikeet_tpu.calling import likelihoods as L
    assert len(jax.devices()) >= 4, f"{len(jax.devices())} devices, need 4"
    fasta, bams, truth = setup(work, clock, kbp)
    base = ["call", "-r", fasta, "-b", *bams, "--force"]
    legs = {}
    for n in (4, 1):
        vcf, _, _, counts = call_leg(
            f"devices{n}", base + ["-t", "1", "--devices", str(n), "-o",
                                   os.path.join(work, f"d{n}")],
            clock, L.DISPATCH_COUNTS)
        assert counts["device"] > 0, f"--devices {n}: nothing on device"
        legs[n] = read_vcf(vcf)
    compare_vcfs("devices 4 vs devices 1", legs[4], legs[1])
    for n, rows in legs.items():
        log(f"recall devices {n}: {recall(rows, truth)!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the serial leg on 4 devices vs 1")
    args = ap.parse_args(argv)

    # pool workers (spawned in the -t 4 leg, inheriting the environment)
    # ship every batch to this process's device service; each leg sets
    # LORIKEET_PAIRHMM_ROUTE itself (call_leg)
    os.environ["LORIKEET_REMOTE_ROUTE"] = "remote"
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"no GPU found: JAX reports {devices[0].platform}",
              file=sys.stderr)
        return 2
    log(f"card: {card_line()}")
    log(f"device: {devices[0].platform} {devices[0].device_kind} "
        f"x{len(devices)}")
    try:
        import sklearn  # noqa: F401 — `genotype` needs it; `call` does not
        log(f"info: sklearn {sklearn.__version__} imports (genotype mode)")
    except ImportError as e:
        log(f"info: sklearn does not import ({e}); genotype mode needs it")
    clock = CompileClock()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        if args.four_cards:
            four_cards(work, clock)
        else:
            one_card(work, clock)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
