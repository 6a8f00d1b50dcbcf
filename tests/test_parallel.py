"""Multichip sharding tests on the virtual 8-device CPU mesh."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lorikeet_tpu.parallel.pipeline import (
    active_probabilities_jax, sharded_activity_step,
)
from lorikeet_tpu.parallel.sharding import make_mesh
from lorikeet_tpu.models.activity import active_probabilities, band_pass_smooth


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return make_mesh(jax.devices()[:8])


def test_active_probabilities_jax_matches_host():
    rng = np.random.default_rng(1)
    S, L, ploidy = 2, 64, 2
    gls = rng.normal(-1.0, 1.5, (S, L, ploidy + 1)).astype(np.float64)
    # plant clearly active positions: strong hom-alt likelihoods
    gls[:, 10] = np.array([-30.0, -5.0, 0.0])
    gls[:, 40] = np.array([-40.0, -8.0, 0.0])
    host = active_probabilities(gls, ploidy)
    dev = np.asarray(active_probabilities_jax(jnp.asarray(gls), ploidy, n_iters=40))
    assert host[10] > 0.99 and dev[10] > 0.99
    assert np.allclose(host, dev, atol=2e-3), np.abs(host - dev).max()


def test_sharded_activity_matches_unsharded(mesh):
    rng = np.random.default_rng(2)
    S, L, ploidy = 2, 256 * 8, 2
    gls = rng.normal(-0.5, 0.3, (S, L, ploidy + 1)).astype(np.float32)
    gls[:, 700] = np.array([-30.0, -5.0, 0.0], np.float32)
    depths = rng.integers(0, 30, (S, L)).astype(np.float32)

    step = sharded_activity_step(mesh, ploidy)
    smoothed, depth_totals = step(jnp.asarray(gls), jnp.asarray(depths))
    smoothed = np.asarray(smoothed)

    raw = np.asarray(active_probabilities_jax(jnp.asarray(gls), ploidy))
    expect = band_pass_smooth(raw)
    assert np.allclose(smoothed, expect, atol=1e-4), np.abs(smoothed - expect).max()
    assert np.allclose(np.asarray(depth_totals), depths.sum(axis=1))
    # the planted active site survives smoothing at the right position
    assert smoothed[700] == smoothed.max()


def test_host_shard_round_robin_partition():
    """Genome-level multi-host sharding (SURVEY §2.4 row 1): shards are a
    disjoint round-robin cover; single-process is the identity."""
    from lorikeet_tpu.parallel.hosts import host_shard
    items = [f"g{i}" for i in range(7)]
    shards = [host_shard(items, i, 3) for i in range(3)]
    assert sorted(x for s in shards for x in s) == sorted(items)
    assert all(not set(a) & set(b)
               for i, a in enumerate(shards) for b in shards[i + 1:])
    assert shards[0] == ["g0", "g3", "g6"]
    assert host_shard(items) == items            # single-host identity


def test_start_engine_honours_host_shard(tmp_path, monkeypatch):
    """Under a 2-process context, each process only writes its own genome
    subset (disjoint output directories)."""
    import os as _os
    from lorikeet_tpu.processing import discover_genomes, start_engine

    specs = discover_genomes(["/root/reference/tests/data/7seqs.fna"])
    names = [s.name for s in specs]
    assert len(names) >= 2
    monkeypatch.setenv("LORIKEET_PROCESS_COUNT", "2")
    outs = []
    for idx in range(2):
        monkeypatch.setenv("LORIKEET_PROCESS_INDEX", str(idx))
        out_dir = str(tmp_path / f"host{idx}")
        start_engine("call", ["/root/reference/tests/data/7seqs.fna"], [],
                     out_dir)
        outs.append({d for d in _os.listdir(out_dir)
                     if _os.path.isdir(_os.path.join(out_dir, d))})
    assert outs[0] | outs[1] == set(names)
    assert not outs[0] & outs[1]
