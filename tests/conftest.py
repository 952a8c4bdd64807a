"""Test config: CPU JAX with an 8-device virtual mesh, plus a `gpu` marker.

The multi-device sharding path (parallel/) is validated on a virtual CPU
mesh per SURVEY §4; `XLA_FLAGS=--xla_force_host_platform_device_count=8`
must be set before jax import.  Pallas kernels run here in interpret mode.
The persistent compile cache keeps re-runs fast.

Tests marked ``gpu`` need a card: they skip on the CPU (decided inside the
``gpu_device`` fixture, never at import time).  On a GPU machine run them
in one process, with the CPU forcing switched off:

    PRT_TEST_PLATFORM=gpu python -m pytest tests -m gpu -p no:xdist
"""
import os

if os.environ.get("PRT_TEST_PLATFORM") != "gpu":
    os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES", "0")
os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0")

import jax

if os.environ.get("PRT_TEST_PLATFORM") != "gpu":
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest

from photorealistic_rendering_using_opencl_tpu.utils.config import (
    enable_compile_cache,
)

enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running test (multi-process/bench-scale)")
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (see gpu_device)")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def uniform_grid(n: int):
    """Low-discrepancy-ish [0,1) grid for deterministic MC tests."""
    u = (np.arange(n, dtype=np.float64) + 0.5) / n
    v = (np.arange(n, dtype=np.float64) * 0.6180339887498949) % 1.0
    return u.astype(np.float32), v.astype(np.float32)
