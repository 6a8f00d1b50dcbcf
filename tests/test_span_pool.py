"""Persistent span-worker pool (parallel.pool): identical results to the
serial path, reuse across genomes, and the parent device-service RPC
(exercised on CPU with forced remote routing), whose failures reach the
parent."""
import os
import tempfile

import numpy as np
import pytest

from lorikeet_tpu.calling.engine import CallerConfig, HaplotypeCallerEngine
from lorikeet_tpu.io.bam import open_bam
from lorikeet_tpu.io.fasta import FastaReader
from lorikeet_tpu.parallel import pool as pool_mod
from lorikeet_tpu.processing import call_contig


def _dataset(tmp, kbp=120, samples=2, seed=0):
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import bench_e2e
    return bench_e2e.simulate_dataset(tmp, kbp, samples, 25.0, seed=seed)


def _key(calls):
    return [(c.tid, c.start, tuple(a.bases for a in c.alleles),
             tuple(tuple(g.alleles[i].bases for i in range(len(g.alleles)))
                   for g in c.genotypes))
            for c in calls]


@pytest.fixture(autouse=True)
def _fresh_pool():
    yield
    pool_mod.shutdown_pool()


def test_pool_matches_serial():
    with tempfile.TemporaryDirectory() as tmp:
        fasta, bams, truth = _dataset(tmp)
        cfg = CallerConfig(use_pallas=False, threads=2)
        fr = FastaReader(fasta)
        readers = [open_bam(p) for p in bams]
        serial = call_contig(fr, readers, "contig1", cfg,
                             HaplotypeCallerEngine(cfg))
        pool = pool_mod.get_pool(fasta, bams, cfg, 2, device_service=False)
        pooled = call_contig(fr, readers, "contig1", cfg,
                             HaplotypeCallerEngine(cfg), pool=pool)
        assert _key(pooled.calls) == _key(serial.calls)
        assert pooled.n_regions == serial.n_regions
        assert pooled.depth_pass_rle == serial.depth_pass_rle


def test_pool_reused_across_genomes():
    with tempfile.TemporaryDirectory() as tmp:
        fasta1, bams1, _ = _dataset(tmp, seed=0)
        cfg = CallerConfig(use_pallas=False, threads=2)
        pool1 = pool_mod.get_pool(fasta1, bams1, cfg, 2,
                                  device_service=False)
        pids = [w.pid for w in pool1.workers]
        tmp2 = os.path.join(tmp, "g2")
        os.makedirs(tmp2)
        fasta2, bams2, truth2 = _dataset(tmp2, kbp=60, seed=3)
        pool2 = pool_mod.get_pool(fasta2, bams2, cfg, 2,
                                  device_service=False)
        assert [w.pid for w in pool2.workers] == pids  # same live workers
        fr2 = FastaReader(fasta2)
        readers2 = [open_bam(p) for p in bams2]
        res = call_contig(fr2, readers2, "contig1", cfg,
                          HaplotypeCallerEngine(cfg), pool=pool2)
        serial = call_contig(fr2, readers2, "contig1", cfg,
                             HaplotypeCallerEngine(cfg))
        assert _key(res.calls) == _key(serial.calls)


def test_pool_device_service_rpc(monkeypatch):
    """Force every worker batch through the parent service (remote routing
    pinned): workers pack grouped jobs, the parent runs the device
    pair-HMM (its plain-JAX implementation on this CPU backend) and replies
    per-pair values.  Results match the serial host path."""
    monkeypatch.setenv("LORIKEET_REMOTE_ROUTE", "remote")
    import lorikeet_tpu.calling.likelihoods as L
    L.DISPATCH_COUNTS["device"] = 0
    with tempfile.TemporaryDirectory() as tmp:
        fasta, bams, truth = _dataset(tmp, kbp=80)
        cfg = CallerConfig(use_pallas=False, threads=2)
        fr = FastaReader(fasta)
        readers = [open_bam(p) for p in bams]
        serial = call_contig(fr, readers, "contig1", cfg,
                             HaplotypeCallerEngine(cfg))
        pool = pool_mod.get_pool(fasta, bams, cfg, 2, device_service=True)
        pooled = call_contig(fr, readers, "contig1", cfg,
                             HaplotypeCallerEngine(cfg), pool=pool)
        assert _key(pooled.calls) == _key(serial.calls)
        assert L.DISPATCH_COUNTS["device"] > 0   # service really dispatched


def _service_failure(monkeypatch, where):
    """Break the service's device seam at ``where`` ("enqueue_jobs" or
    "readback") and run a pooled call: the error must reach the parent."""
    monkeypatch.setenv("LORIKEET_REMOTE_ROUTE", "remote")
    import lorikeet_tpu.ops.pairhmm_device as D

    def broken(*args, **kwargs):
        raise RuntimeError(f"simulated device failure in {where}")

    monkeypatch.setattr(D, where, broken)
    with tempfile.TemporaryDirectory() as tmp:
        fasta, bams, truth = _dataset(tmp, kbp=80)
        cfg = CallerConfig(use_pallas=False, threads=2)
        fr = FastaReader(fasta)
        readers = [open_bam(p) for p in bams]
        pool = pool_mod.get_pool(fasta, bams, cfg, 2, device_service=True)
        with pytest.raises(RuntimeError) as err:
            call_contig(fr, readers, "contig1", cfg,
                        HaplotypeCallerEngine(cfg), pool=pool)
    msg = str(err.value)
    assert "span worker failed" in msg and "device service failed" in msg
    assert f"simulated device failure in {where}" in msg


def test_service_launch_error_reaches_parent(monkeypatch):
    """A device launch failure is not bounced to the worker's host
    kernel: the run fails in the parent."""
    _service_failure(monkeypatch, "enqueue_jobs")


def test_service_readback_error_reaches_parent(monkeypatch):
    """A failure while reading results back fails the run the same way."""
    _service_failure(monkeypatch, "readback")


def test_pool_survives_worker_kill():
    """Crash tolerance: SIGKILL one worker mid-span — its in-flight task is
    requeued onto the survivor, a replacement is respawned, and the calls
    are identical to the serial path (reference analogue: per-genome
    try/continue, src/processing/lorikeet_engine.rs:100)."""
    import signal
    import threading
    import time

    with tempfile.TemporaryDirectory() as tmp:
        fasta, bams, _ = _dataset(tmp, kbp=300, seed=1)
        cfg = CallerConfig(use_pallas=False, threads=2)
        fr = FastaReader(fasta)
        readers = [open_bam(p) for p in bams]
        serial = call_contig(fr, readers, "contig1", cfg,
                             HaplotypeCallerEngine(cfg))
        pool = pool_mod.get_pool(fasta, bams, cfg, 2, device_service=False)
        killed = []

        def killer():
            for _ in range(3000):          # wait for a span to be in flight
                if pool._inflight:
                    wid = next(iter(pool._inflight.values()))
                    time.sleep(0.05)       # clear of queue-lock windows
                    os.kill(pool._wid_proc[wid].pid, signal.SIGKILL)
                    killed.append(wid)
                    return
                time.sleep(0.01)

        t = threading.Thread(target=killer)
        t.start()
        pooled = call_contig(fr, readers, "contig1", cfg,
                             HaplotypeCallerEngine(cfg), pool=pool)
        t.join()
        assert killed, "killer never saw an in-flight span"
        assert _key(pooled.calls) == _key(serial.calls)
        assert pooled.depth_pass_rle == serial.depth_pass_rle
        # capacity restored: the dead worker was replaced
        assert sum(w.is_alive() for w in pool.workers) == 2


def test_worker_error_surfaces():
    with tempfile.TemporaryDirectory() as tmp:
        fasta, bams, _ = _dataset(tmp, kbp=40)
        cfg = CallerConfig(use_pallas=False, threads=1)
        pool = pool_mod.get_pool(fasta, bams, cfg, 1, device_service=False)
        tid = pool.submit("no_such_contig", (0, 1000, 0, 1000))
        with pytest.raises(RuntimeError, match="span worker failed"):
            pool.gather([tid])
