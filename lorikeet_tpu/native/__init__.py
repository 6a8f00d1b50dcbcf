"""Native components, compiled on demand and loaded via ctypes: C++ host
kernels with g++, the CUDA pair-HMM with nvcc.

A library is keyed on a hash of its sources, its compile command and the
host's CPU, and lives under ``_build/`` (git-ignored).  So what runs was
built from the sources on disk, on the machine that runs it: a library
built elsewhere (another CPU under ``-march=native``) has another key and
is never picked up."""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import threading

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, "_build")
_LOCK = threading.Lock()
_LIBS = {}
#: seconds spent compiling native libraries in this process (set-up time)
BUILD_SECONDS = {}


def host_cpu() -> str:
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        with open("/proc/cpuinfo") as fh:
            lines = fh.read().split("\n\n")[0].splitlines()
        keep = [l for l in lines
                if l.split(":")[0].strip() in ("model name", "flags")]
        if keep:
            return "\n".join(keep)
    except OSError:
        pass
    return f"{platform.machine()} {platform.processor()}"


def build_key(sources: list[str], cmd: list[str]) -> str:
    """Hash of the sources' bytes, the compile command and the host CPU."""
    h = hashlib.sha256()
    for src in sources:
        h.update(os.path.basename(src).encode())
        with open(src, "rb") as fh:
            h.update(fh.read())
    h.update("\0".join(cmd).encode())
    h.update(host_cpu().encode())
    return h.hexdigest()[:16]


def _load(name: str, sources: list[str], cmd: list[str],
          tail: list[str]) -> ctypes.CDLL:
    """Build ``cmd + [-o lib] + sources + tail`` unless a library with the
    same key exists, then load it."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        srcs = [os.path.join(_DIR, s) for s in sources]
        so_path = os.path.join(
            BUILD_DIR, f"lib{name}-{build_key(srcs, cmd + tail)}.so")
        if not os.path.exists(so_path):
            import time
            os.makedirs(BUILD_DIR, exist_ok=True)
            # concurrent builds (pool workers) each write their own file;
            # the rename makes the finished library appear atomically
            tmp = f"{so_path}.{os.getpid()}.tmp"
            t0 = time.perf_counter()
            try:
                subprocess.run(cmd + ["-o", tmp] + srcs + tail, check=True,
                               capture_output=True, text=True)
            except subprocess.CalledProcessError as e:
                raise RuntimeError(
                    f"building lib{name} failed:\n{e.stderr}") from e
            os.replace(tmp, so_path)
            BUILD_SECONDS[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(so_path)
        _LIBS[name] = lib
        return lib


def load(name: str, sources: list[str], link: list[str] = ()) -> ctypes.CDLL:
    """Compile (if no library with this key exists) and load a C++ host
    library."""
    cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC"]
    return _load(name, sources, cmd, list(link))


def nvcc() -> str | None:
    """Path of the CUDA compiler, or None where the toolkit is absent."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    return cand if os.path.exists(cand) else None


def load_cuda(name: str, sources: list[str]) -> ctypes.CDLL:
    """Compile (if no library with this key exists) and load a CUDA library
    for Hopper (sm_90a) that exports XLA FFI handlers."""
    compiler = nvcc()
    if compiler is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put it on PATH")
    import jax.ffi
    cmd = [compiler, "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-I", jax.ffi.include_dir()]
    return _load(name, sources, cmd, [])
