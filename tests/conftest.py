import os

import pytest

# Tests run on a virtual 8-device CPU mesh, so the sharding logic runs
# without a GPU.  chip_smoke.py sets LORIKEET_TEST_GPU=1 to run the
# `gpu`-marked tests in its own process on the card; then the backend is
# left alone.  jax.config is set as well as the variable, in case jax was
# imported before this file.
if os.environ.get("LORIKEET_TEST_GPU") != "1":
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax  # noqa: E402

    jax.config.update("jax_platforms", "cpu")

REFERENCE_DIR = "/root/reference"


def reference_path(*parts):
    return os.path.join(REFERENCE_DIR, *parts)


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is an NVIDIA GPU (decided here, at
    run time, never while a module is imported)."""
    import jax
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU: run `python chip_smoke.py` on one")
