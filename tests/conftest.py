"""Test harness configuration.

Tests run on a CPU backend with 8 virtual devices so multi-device sharding
(`opticomlib_tpu.parallel`) is exercised without accelerators
(`--xla_force_host_platform_device_count=8`).  The CPU is the default;
set ``JAX_PLATFORMS`` to choose another platform, e.g. on a GPU host

    JAX_PLATFORMS=cuda,cpu python -m pytest -m chip tests/

runs the tests marked ``chip``, which skip (inside their fixture) when
the default device is not a GPU.
"""
import os

import jax

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()
if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _reset_globals():
    """Reset the global parameter facade before each test (the reference's
    tests do the same with gv.default(); see reference tests/ook_test.py:9-11)."""
    from opticomlib_tpu import gv
    gv.default()
    np.random.seed(0)
    yield
    gv.default()


@pytest.fixture
def gpu():
    """The default device when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU as the default device "
                    "(JAX_PLATFORMS=cuda,cpu on a GPU host)")
    return dev
