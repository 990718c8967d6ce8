"""Test configuration: run the suite on a virtual 8-device CPU mesh.

JAX programs are backend-portable; sharding tests need multiple devices,
so the host platform exposes 8 virtual CPU devices. XLA_FLAGS is read at
first backend initialization, so setting it here works.

The suite runs on the CPU unless JAX_PLATFORMS says otherwise; tests
marked `chip` need the GPU and skip elsewhere (see
tests/test_kernels_chip.py and chip_smoke.py).
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
