"""Persistent span-worker pool + parent-side device service.

The reference scales one genome over cores with rayon
(/root/reference/src/assembly/assembly_region_walker.rs:139-141 region
fan-out under the global pool of src/bin/lorikeet.rs:29-32).  Here:

- N long-lived worker PROCESSES (spawned once, reused across chunks,
  contigs and genomes, since each start costs seconds of imports) run the
  CPU side of each chunk span: BAM decode, activity profile, assembly,
  genotyping.  They never open the device: each is spawned with
  JAX_PLATFORMS=cpu in its environment.
- The PARENT process owns the device.  Each worker holds an RPC pipe;
  when its cost model picks the device, a pair-HMM batch is packed in the
  worker, shipped to the parent, run by the device pair-HMM, and the
  result returned.  Two batches stay in flight, so worker-N's device batch
  overlaps worker-M's host prep.  A device failure is returned to the
  worker as an error and fails the run through gather().
- With no accelerator the same pool is a persistent chunk-process map
  (the reference's rayon chunk loop, amortized startup).
"""
from __future__ import annotations

import atexit
import os
import threading
import traceback

import numpy as np

_POOLS = {}           # key -> SpanWorkerPool (small LRU; see get_pool)
_MAX_POOLS = 2        # idle workers cost no CPU, but each holds BAM caches


def _worker_main(wid, cfg, task_q, result_q, rpc_conn):
    """Worker process entry: CPU-only jax (see SpanWorkerPool._spawn_worker),
    persistent readers/engine, span loop.  With ``rpc_conn`` the likelihood
    layer may ship batches to the parent's device service.  Readers are
    cached per (fasta, bams) input set so one pool serves many genomes
    (--parallel-genomes, multi-genome dirs) without re-decoding."""
    from lorikeet_tpu.calling import likelihoods as L
    from lorikeet_tpu.calling.engine import HaplotypeCallerEngine
    from lorikeet_tpu.io.bam import open_bam
    from lorikeet_tpu.io.fasta import FastaReader
    from lorikeet_tpu.processing import _call_span

    import queue as _q
    import time as _time

    from lorikeet_tpu.calling.engine import call_regions_batched

    readers = {}                           # (fasta, bams) -> state, max 2
    engine = HaplotypeCallerEngine(cfg)

    def _readers_for(fasta_path, bam_paths):
        key = (fasta_path, tuple(bam_paths))
        state = readers.get(key)
        if state is None:
            if len(readers) >= 2:          # bound decoded-BAM memory
                readers.pop(next(iter(readers)))
            # the open_bam size heuristic is per FILE; a worker holds every
            # sample at once, so stream when the AGGREGATE would blow the
            # eager budget (8 x 120 MB BAMs measured 3.7 GB/worker eager)
            high_mem = getattr(cfg, "high_memory", False)
            streaming = None
            if not high_mem:
                try:
                    total = sum(os.path.getsize(p) for p in bam_paths)
                except OSError:
                    total = 0
                threshold = int(os.environ.get(
                    "LORIKEET_EAGER_BAM_MAX", str(256 * 1024 * 1024)))
                if total > threshold:
                    streaming = True
            state = (FastaReader(fasta_path),
                     [open_bam(p, high_memory=high_mem, streaming=streaming)
                      for p in bam_paths])
            readers[key] = state
        return state

    def _local_lks(works):
        pairs = [p for w in works for p in w.pairs]
        return L.compute_pair_likelihoods(pairs, use_pallas=False)

    def _genotype_and_put(tid, res, works, lks):
        for calls in call_regions_batched(engine, works, lks) if works \
                else []:
            res.calls.extend(calls)
        result_q.put((tid, "ok", res))

    # ---- async span pipeline (device service present) --------------------
    # pack span-N's pair batch into ready-to-run dispatch jobs (the
    # worker's CPU pays the packing — it replaces the worker's own kernel
    # time; the parent's service thread must stay thin on a shared box),
    # ship them to the parent's device, prep span-N+1 while it computes,
    # then map+validate+genotype N on the flat reply.  One outstanding RPC
    # per worker; profitability is learned from the WAIT time at recv (a
    # ~0 wait means the device overlapped for free), so a saturated
    # service pushes batches back to the local host kernel automatically.
    pending = None                 # (tid, res, works, t_sent)

    def _finish(p):
        tid2, res2, works2, t_send = p
        try:
            t0 = _time.perf_counter()
            kind, payload = rpc_conn.recv()
            waited = _time.perf_counter() - t0
            if kind != "ok":
                raise RuntimeError(f"device service failed:\n{payload}")
            pairs = [pp for w in works2 for pp in w.pairs]
            _, bytes_est = L._batch_cost_inputs(pairs)
            # overlap-aware rate: the worker's real cost is the pack+send
            # CPU plus the time it ends up blocked on the reply — a fully
            # overlapped batch costs only the send
            L._update_perf("rem_bps", bytes_est, t_send + max(waited, 1e-4))
            L.DISPATCH_COUNTS["remote"] += 1
            from lorikeet_tpu.ops.pairhmm import pairhmm_forward_checked
            lks = pairhmm_forward_checked(payload, pairs)
            _genotype_and_put(tid2, res2, works2, lks)
        except Exception:  # noqa: BLE001 — surface to the parent
            result_q.put((tid2, "error", traceback.format_exc()))

    while True:
        if pending is not None:
            try:
                task = task_q.get_nowait()
            except _q.Empty:
                _finish(pending)
                pending = None
                continue
        else:
            task = task_q.get()
        if task is None:
            if pending is not None:
                _finish(pending)
                pending = None
            break
        tid, fasta_path, bam_paths, contig, sp = task
        # announce pickup so the parent can requeue this task if we die
        # mid-span (crash tolerance; reference analogue: the per-genome
        # try/continue of src/processing/lorikeet_engine.rs:100)
        result_q.put((tid, "start", wid))
        try:
            fasta, bams = _readers_for(fasta_path, bam_paths)
            if rpc_conn is None:
                res = _call_span(fasta, bams, contig, cfg, engine, *sp)
                result_q.put((tid, "ok", res))
                continue
            res, works = _call_span(fasta, bams, contig, cfg, engine, *sp,
                                    defer=True)
            pairs = [p for w in works for p in w.pairs]
            from lorikeet_tpu.ops.pairhmm_device import (
                MAX_READ_LEN, prepare_jobs,
            )
            # reads past the device kernel's length limit stay on the
            # worker's host kernel (the stated length test of
            # calling.likelihoods.compute_pair_likelihoods)
            if pairs and max(len(p[1]) for p in pairs) <= MAX_READ_LEN \
                    and L._route_remote(pairs):
                t0 = _time.perf_counter()
                jobs = prepare_jobs(pairs)
                t_prep = _time.perf_counter() - t0
                # drain the previous reply BEFORE sending the next request:
                # a duplex pipe with a blocked send on BOTH ends (parent
                # pushing reply N, worker pushing request N+1, each larger
                # than the socket buffer) is a hard deadlock.  Overlap is
                # unharmed — span N+1's host prep already ran while the
                # device chewed batch N; only the cheap send moves.
                if pending is not None:
                    _finish(pending)
                    pending = None
                t0 = _time.perf_counter()
                rpc_conn.send(("lkd", jobs))
                t_send = t_prep + _time.perf_counter() - t0
                pending = (tid, res, works, t_send)
            else:
                if pending is not None:
                    _finish(pending)
                    pending = None
                _genotype_and_put(tid, res, works,
                                  _local_lks(works) if pairs else None)
        except Exception:  # noqa: BLE001 — surface to the parent
            result_q.put((tid, "error", traceback.format_exc()))
            if pending is not None:
                # drain the outstanding RPC reply (and emit the pending
                # span's result) — dropping it would leave the stale reply
                # in the pipe, and every LATER remote batch in this worker
                # would recv the previous batch's likelihoods: silent
                # corruption of all subsequent genomes
                _finish(pending)
                pending = None
    if rpc_conn is not None:
        rpc_conn.send(("bye", None))


class SpanWorkerPool:
    """Persistent worker pool over chunk spans; see module docstring."""

    def __init__(self, cfg, n_workers: int, device_service: bool):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")
        self.key = None                      # set by get_pool
        self.n_workers = n_workers
        self._ctx = ctx
        self._cfg = cfg
        self._device_service = device_service
        self.task_q = ctx.Queue()
        self.result_q = ctx.Queue()
        self._next_id = 0
        self._next_wid = 0
        self._results = {}
        self._tasks = {}                     # tid -> task tuple (requeue)
        self._inflight = {}                  # tid -> wid ("start" seen)
        self._retries = {}                   # tid -> requeue count
        self._dead_handled = set()           # wids already recovered
        self._lock = threading.Lock()
        self._service_stop = threading.Event()
        self._service_thread = None
        self._conns = []
        self._wid_proc = {}
        self.workers = [self._spawn_worker() for _ in range(n_workers)]
        if device_service and self._conns:
            self._service_thread = threading.Thread(
                target=self._serve_device, daemon=True)
            self._service_thread.start()

    def _spawn_worker(self):
        """Start one worker process (initial fill or crash replacement).
        The child starts with JAX_PLATFORMS=cpu in its environment: the
        spawn bootstrap imports jax (unpickling cfg does) before any code
        of the worker runs, and jax reads the variable at import, so
        setting it inside the worker would be too late to keep it off the
        parent's device."""
        from lorikeet_tpu.device import cpu_only_children
        wid = self._next_wid
        self._next_wid += 1
        child_c = None
        if self._device_service:
            parent_c, child_c = self._ctx.Pipe()
            self._conns.append(parent_c)
        p = self._ctx.Process(
            target=_worker_main,
            args=(wid, self._cfg, self.task_q, self.result_q, child_c),
            daemon=True)
        with cpu_only_children():
            p.start()
        # pipe fds are inherited by the spawned child via pickling; the
        # parent closes its copy of the child end
        if child_c is not None:
            child_c.close()
        self._wid_proc[wid] = p
        return p

    # ---- crash tolerance --------------------------------------------------
    def _requeue(self, tid):
        n = self._retries.get(tid, 0)
        if n >= 2:
            raise RuntimeError(
                f"span task {tid} was lost to {n} worker crash(es) and "
                "re-ran out of retries (likely a reproducible native "
                "fault in this span)")
        self._retries[tid] = n + 1
        self.task_q.put(self._tasks[tid])

    def recover_dead_workers(self) -> bool:
        """Requeue tasks that died with their worker onto the survivors and
        respawn replacements, keeping pool capacity.  The reference keeps a
        genome alive past a failed scope task
        (src/processing/lorikeet_engine.rs:100); the pool matches that with
        task-level requeue instead of aborting the run."""
        changed = False
        for wid, p in list(self._wid_proc.items()):
            if wid in self._dead_handled or p.is_alive():
                continue
            self._dead_handled.add(wid)
            changed = True
            for t in [t for t, w in self._inflight.items() if w == wid]:
                del self._inflight[t]
                self._requeue(t)
            new_p = self._spawn_worker()
            try:
                self.workers[self.workers.index(p)] = new_p
            except ValueError:
                self.workers.append(new_p)
        return changed

    # ---- parent-side device service ---------------------------------------
    def _serve_device(self):
        """Serve pair-HMM batches from workers on the parent's device.  Two
        batches stay in flight: the readback of batch N waits until batch
        N+1 is launched.  A launch or readback failure is sent back as an
        error; the worker raises it and gather() fails the run, so no
        batch silently falls back to the host."""
        from multiprocessing.connection import wait as conn_wait

        from lorikeet_tpu.calling import likelihoods as L
        from lorikeet_tpu.device import device_impl
        from lorikeet_tpu.ops.pairhmm_device import enqueue_jobs, readback

        impl = device_impl()
        devices = L.mesh_devices()
        inflight = []                      # [(conn, outs)]

        def reply(conn, msg):
            try:
                conn.send(msg)
            except OSError:
                pass       # the worker exited; nobody waits for this reply

        def finish(item):
            conn, outs = item
            try:
                # per-pair f64 (~64 KB): a small reply cannot block the
                # service thread against a worker that is mid-span
                msg = ("ok", readback(outs))
            except Exception:  # noqa: BLE001 — reported to the worker
                msg = ("error", traceback.format_exc())
            reply(conn, msg)

        closed = set()
        while not self._service_stop.is_set():
            # live is recomputed each pass so crash-replacement workers
            # (recover_dead_workers appends their conns) get served too
            live = [c for c in self._conns if c not in closed]
            if not live:
                if self._service_stop.wait(0.2):
                    break
                continue
            # with work in flight, only drain IMMEDIATELY-pending requests
            # before reading results back — a lone worker must not eat a
            # poll-interval latency per span
            ready = conn_wait(live, timeout=0.0 if inflight else 0.2)
            if not ready:
                while inflight:
                    finish(inflight.pop(0))
                continue
            for conn in ready:
                try:
                    kind, payload = conn.recv()
                except (EOFError, OSError):
                    closed.add(conn)
                    continue
                if kind == "bye":
                    closed.add(conn)
                    continue
                try:
                    # inside the try: a malformed payload must be answered,
                    # never kill the service thread (workers block on
                    # their replies forever if it dies)
                    L.DISPATCH_COUNTS["device"] += 1
                    inflight.append((conn, enqueue_jobs(payload, impl,
                                                        devices)))
                except Exception:  # noqa: BLE001 — reported to the worker
                    reply(conn, ("error", traceback.format_exc()))
                while len(inflight) > 1:
                    finish(inflight.pop(0))
        while inflight:
            finish(inflight.pop(0))

    # ---- task API ---------------------------------------------------------
    def submit(self, contig: str, span, fasta_path: str = None,
               bam_paths: list = None) -> int:
        with self._lock:
            tid = self._next_id
            self._next_id += 1
        task = (tid, fasta_path or self.default_fasta,
                bam_paths or self.default_bams, contig, span)
        self._tasks[tid] = task
        self.task_q.put(task)
        return tid

    def gather(self, task_ids: list) -> list:
        """Results for ``task_ids`` in that order (blocks).  Worker deaths
        are survived: their in-flight tasks are requeued onto the
        survivors and replacements are respawned (retry-capped so a span
        that reproducibly kills workers still surfaces as an error)."""
        want = set(task_ids)
        idle_polls = 0
        while want - self._results.keys():
            try:
                tid, status, payload = self.result_q.get(timeout=5.0)
            except Exception:  # noqa: BLE001 — queue.Empty: recovery check
                if self.recover_dead_workers():
                    idle_polls = 0
                    continue
                # ghost recovery: a worker that died between task pickup
                # and its "start" message leaves a task with no result, no
                # in-flight owner, and nothing queued.  Only possible after
                # a death, so gate on one having happened.
                missing = [t for t in want if t not in self._results
                           and t not in self._inflight]
                if missing and self._dead_handled and self.task_q.empty():
                    idle_polls += 1
                    if idle_polls >= 2:
                        for t in missing:
                            self._requeue(t)
                        idle_polls = 0
                continue
            if status == "start":
                self._inflight[tid] = payload
                continue
            if status == "error":
                raise RuntimeError(f"span worker failed:\n{payload}")
            self._inflight.pop(tid, None)
            self._results[tid] = payload
            self._tasks.pop(tid, None)
        return [self._results.pop(t) for t in task_ids]

    def close(self):
        self._service_stop.set()
        for _ in self.workers:
            try:
                self.task_q.put(None)
            except Exception:  # noqa: BLE001
                pass
        for w in self.workers:
            w.join(timeout=10)
            if w.is_alive():
                w.terminate()
        if self._service_thread is not None:
            self._service_thread.join(timeout=5)


def get_pool(fasta_path: str, bam_paths: list, cfg, n_workers: int,
             device_service: bool):
    """Keyed accessor: reuse a live pool when (cfg, size, service) match —
    a pool serves any (fasta, bams) input set, so it survives across
    contigs AND genomes.  Worker startup costs ~4 s each; keeping them
    alive is what fixes the 4-process scaling row.  A small registry (not
    a singleton) lets two configurations alternate (e.g. host-kernel vs
    device-routed legs of an A/B race) without paying respawn per switch."""
    from lorikeet_tpu.processing import _cfg_fingerprint
    key = (_cfg_fingerprint(cfg), n_workers, device_service)
    pool = _POOLS.get(key)
    if pool is not None:
        try:
            pool.recover_dead_workers()    # respawn any crash casualties
            ok = all(w.is_alive() for w in pool.workers)
        except Exception:  # noqa: BLE001 — unrecoverable: rebuild below
            ok = False
        if ok:
            _POOLS[key] = _POOLS.pop(key)  # LRU touch
            pool.default_fasta = fasta_path
            pool.default_bams = list(bam_paths)
            return pool
        _POOLS.pop(key, None)
        pool.close()
    while len(_POOLS) >= _MAX_POOLS:
        _POOLS.pop(next(iter(_POOLS))).close()
    pool = SpanWorkerPool(cfg, n_workers, device_service)
    pool.key = key
    pool.default_fasta = fasta_path
    pool.default_bams = list(bam_paths)
    _POOLS[key] = pool
    return pool


def pool_alive() -> bool:
    """True when a live pool exists (its spawn cost is already paid)."""
    return any(all(w.is_alive() for w in p.workers)
               for p in _POOLS.values())


def shutdown_pool():
    while _POOLS:
        _POOLS.pop(next(iter(_POOLS))).close()


atexit.register(shutdown_pool)
