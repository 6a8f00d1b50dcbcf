"""The process-wide device mesh.

The reference scales with shared-memory thread pools (rayon par_iter over
contigs/chunks/regions, /root/reference/src/haplotype/haplotype_caller_engine.rs:443-465,
assembly_region_walker.rs:139-141).  Here a 1-D jax.sharding Mesh over the
visible devices carries two things: pair-HMM dispatches round-robin over its
devices (calling.likelihoods), and the activity chain shards its position
axis over it (parallel.pipeline).
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh


def make_mesh(devices=None, axis_name: str = "data") -> Mesh:
    """1-D data-parallel mesh over all (or given) devices."""
    devices = np.array(devices if devices is not None else jax.devices())
    return Mesh(devices, (axis_name,))


#: process-wide device mesh the production pipeline dispatches pair batches
#: over (None = single-device dispatch).  Set once by processing.start_engine
#: / the CLI --devices knob; read by calling.likelihoods.
_ACTIVE_MESH: Mesh | None = None


def set_mesh(mesh: Mesh | None):
    global _ACTIVE_MESH
    _ACTIVE_MESH = mesh


def get_mesh() -> Mesh | None:
    return _ACTIVE_MESH


def configure_mesh(devices: str | int | None = "auto") -> Mesh | None:
    """Resolve the --devices knob: 'auto' = every visible accelerator
    (mesh only when >1), an int = that many, None/1/0 = single-device.
    Returns the mesh that was activated (or None)."""
    if devices in (None, 0, 1, "1", "none"):
        set_mesh(None)
        return None
    devs = jax.devices()
    if devices != "auto":
        devs = devs[:int(devices)]
    if len(devs) <= 1:
        set_mesh(None)
        return None
    mesh = make_mesh(devs)
    set_mesh(mesh)
    return mesh


def demo_pairs(n_pairs: int, R: int = 16, H: int = 32, seed: int = 0):
    """Tiny synthetic (hap, read, q, iq, dq, gcp) pairs (dry runs, tests)."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    haps = bases[rng.integers(0, 4, (n_pairs, H))]
    q = np.full(R, 30, np.uint8)
    i45 = np.full(R, 45, np.uint8)
    g10 = np.full(R, 10, np.uint8)
    return [(h, np.ascontiguousarray(h[:R]), q, i45, i45, g10) for h in haps]
