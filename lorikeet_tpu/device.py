"""Which device this process computes on, and by which route.

One place decides, from JAX's backend:

- ``pairhmm_route``: "cuda" (the hand-written kernel, on an NVIDIA GPU),
  "xla" (the plain-JAX wavefront, on any other accelerator JAX drives), or
  "host" (the exact f64 C++ kernel, on the CPU backend);
- ``device_impl``: the implementation a device route runs, also when a
  caller pins the device route on the CPU backend (tests do);
- ``setup_compile_cache``: where JAX keeps compiled programs.
"""
from __future__ import annotations

import contextlib
import os

#: the persistent compile cache when JAX_COMPILATION_CACHE_DIR is unset:
#: one fixed path inside the checkout (the path is part of the cache key,
#: so it never depends on a temporary name, a process id or the time)
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def backend() -> str:
    import jax
    return jax.default_backend()


def pairhmm_route(platform: str | None = None) -> str:
    """"host", "cuda" or "xla" for a JAX platform (default: this process's
    backend)."""
    platform = backend() if platform is None else platform
    if platform == "cpu":
        return "host"
    return device_impl(platform)


def device_impl(platform: str | None = None) -> str:
    """The device pair-HMM implementation for a platform: the CUDA kernel
    on a GPU, the plain-JAX wavefront elsewhere."""
    platform = backend() if platform is None else platform
    return "cuda" if platform in ("gpu", "cuda") else "xla"


def setup_compile_cache() -> str:
    """Use JAX's persistent compile cache.  If JAX_COMPILATION_CACHE_DIR is
    set, JAX reads it and nothing else is set here; otherwise the cache
    goes to DEFAULT_CACHE_DIR.  Returns the directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR


@contextlib.contextmanager
def cpu_only_children():
    """Hold JAX_PLATFORMS=cpu in this process's environment while child
    processes start: a spawned child copies the environment at start, and
    jax reads the variable when the child's bootstrap first imports it.
    So no child opens the device (one process per card).  Jax in this
    process read the variable long before, so the change does not touch
    it."""
    old = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("JAX_PLATFORMS", None)
        else:
            os.environ["JAX_PLATFORMS"] = old


def describe(force_host: bool = False) -> str:
    """One line naming the device and the pair-HMM route, for the log."""
    import jax
    dev = jax.devices()[0]
    route = "host" if force_host else pairhmm_route(dev.platform)
    return (f"device {dev.platform}:{dev.device_kind} x{len(jax.devices())}"
            f", pair-HMM route {route}")
