"""Test configuration: run everything on a virtual 8-device CPU mesh so the
multi-device sharding paths are exercised without GPUs.

XLA_FLAGS is set and jax_platforms flipped to the CPU before any backend
starts, so the tests stay on the CPU even on a machine with a GPU.
Checks that need the card live in chip_smoke.py.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def cpu_devices():
    return jax.devices()
