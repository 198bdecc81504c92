"""Test configuration: force an 8-virtual-device CPU backend.

Tests exercise the multi-device sharding paths on a virtual CPU mesh, so
the suite runs the same on any machine, with or without a GPU.  Both
settings must be in place before the first JAX operation starts the
backends.  Tests that need a card are marked ``gpu`` and run it in a
process of their own (tests/test_chip_smoke.py).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def key():
    return jax.random.key(0)
