"""lorikeet_tpu.device (route, compile cache, child environment), the
native build key, and chip_smoke.py's refusal to run without a GPU."""
import os
import shutil
import subprocess
import sys

import pytest

from lorikeet_tpu import device, native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,route,impl", [
    ("cpu", "host", "xla"),
    ("gpu", "cuda", "cuda"),
    ("cuda", "cuda", "cuda"),
    ("rocm", "xla", "xla"),
])
def test_pairhmm_route(platform, route, impl):
    assert device.pairhmm_route(platform) == route
    assert device.device_impl(platform) == impl


def test_route_follows_this_backend():
    assert device.backend() == "cpu"
    assert device.pairhmm_route() == "host"
    assert "pair-HMM route host" in device.describe()
    assert "route host" in device.describe(force_host=True)


def test_compile_cache_env_set_wins(monkeypatch, tmp_path):
    import jax
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert device.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before   # nothing set


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch):
    import jax
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = device.setup_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert device.setup_compile_cache() == path         # stable
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("preset", [None, "gpu"])
def test_cpu_only_children_env(monkeypatch, preset):
    if preset is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", preset)
    with device.cpu_only_children():
        assert os.environ["JAX_PLATFORMS"] == "cpu"
    assert os.environ.get("JAX_PLATFORMS") == preset


def test_spawned_child_sees_cpu_only(monkeypatch):
    import multiprocessing as mp
    monkeypatch.setenv("JAX_PLATFORMS", "gpu")
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=_report_platforms, args=(q,))
    with device.cpu_only_children():
        p.start()
    p.join(60)
    assert q.get(timeout=5) == "cpu"


def _report_platforms(q):
    q.put(os.environ.get("JAX_PLATFORMS"))


def _write(path, text):
    with open(path, "w") as fh:
        fh.write(text)
    return str(path)


def test_build_key_tracks_source_bytes(tmp_path):
    src = _write(tmp_path / "a.cpp", "int f() { return 1; }\n")
    k1 = native.build_key([src], ["g++", "-O3"])
    _write(tmp_path / "a.cpp", "int f() { return 2; }\n")
    k2 = native.build_key([src], ["g++", "-O3"])
    os.utime(src, (0, 0))               # an older mtime changes nothing
    assert k1 != k2 == native.build_key([src], ["g++", "-O3"])


def test_build_key_tracks_flags(tmp_path):
    src = _write(tmp_path / "a.cpp", "int f() { return 1; }\n")
    assert native.build_key([src], ["g++", "-O3"]) != \
        native.build_key([src], ["g++", "-O2"])


def test_build_key_tracks_host_cpu(tmp_path, monkeypatch):
    src = _write(tmp_path / "a.cpp", "int f() { return 1; }\n")
    k1 = native.build_key([src], ["g++"])
    monkeypatch.setattr(native, "host_cpu", lambda: "another cpu")
    assert native.build_key([src], ["g++"]) != k1


def test_native_library_built_under_its_key():
    from lorikeet_tpu.ops.pairhmm_native import native_available
    if shutil.which("g++") is None:
        pytest.skip("no C++ toolchain")
    assert native_available()
    libs = [f for f in os.listdir(native.BUILD_DIR)
            if f.startswith("libpairhmm-") and f.endswith(".so")]
    srcs = [os.path.join(os.path.dirname(native.__file__), "pairhmm.cpp")]
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC"]
    assert f"libpairhmm-{native.build_key(srcs, cmd)}.so" in libs


def test_chip_smoke_refuses_cpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert "no GPU found" in out.stderr
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
