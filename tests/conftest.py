"""Test harness: the CPU backend with 8 virtual devices.

The tests run on the CPU — the oracle's home — with an 8-device virtual
mesh so sharding logic is exercised without several cards (the standard
JAX substitute for a fake distributed backend; SURVEY.md section 4).
An explicit JAX_PLATFORMS is respected, which is how the ``gpu``-marked
tests run on a card (tests/test_gpu.py).
"""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def devices8():
    devs = jax.devices("cpu")
    assert len(devs) >= 8, f"expected 8 virtual CPU devices, got {len(devs)}"
    return devs[:8]


@pytest.fixture(scope="session")
def rtol():
    return 1e-5
