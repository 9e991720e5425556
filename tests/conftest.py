"""Test configuration: an 8-virtual-device CPU mesh by default.

Replaces the reference's SimulatedDistributedEnv monkeypatch approach
(/root/reference/test_parallelism.py:806-886) with REAL multi-device
execution: XLA's host-platform device count gives 8 actual devices so mesh
collectives (psum/ppermute/all_gather) run for real in tests.

``MLIO_TEST_PLATFORM=gpu`` opts out of the CPU pin so the tests marked
``gpu`` (kernels compiled for the card, no interpret mode) run on the card:

    MLIO_TEST_PLATFORM=gpu python -m pytest tests/ -m gpu

Without it those tests skip, and everything else runs on the CPU. The
persistent compilation cache is off in tests so runs stay independent.
"""
import os

ON_GPU = os.environ.get("MLIO_TEST_PLATFORM") == "gpu"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_enable_compilation_cache", False)
if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """Skip unless the tests were started on the card (see module doc)."""
    if not ON_GPU or jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU: run with MLIO_TEST_PLATFORM=gpu")
