"""Test environment: CPU backend with 8 virtual devices by default.

Unit tests run on the CPU backend, where the scans take the plain XLA route
and the GPU kernel runs under the Pallas interpreter; mesh/sharding tests
use 8 virtual host devices. The flags must be in place before the first
backend initialization. ``JAX_PLATFORMS`` set in the environment wins, so
the ``gpu``-marked tests run on the card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``; elsewhere the
``gpu`` fixture skips them.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import gc

import jax
import pytest


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time,
    never at import or collection)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda on the card")
    return jax.devices()[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables after each test module.

    The suite performs hundreds of unique XLA:CPU compilations in one
    process; with all executables kept alive the compiler eventually
    segfaults (observed reproducibly around the last module on a 1-CPU
    host). Clearing per-module keeps peak compiler state bounded without
    recompiling within a module.
    """
    yield
    jax.clear_caches()
    gc.collect()
