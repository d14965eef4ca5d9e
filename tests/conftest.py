"""Test configuration: the CPU backend with 8 virtual devices.

Tests run without an accelerator; sharding tests use an 8-device CPU mesh.
JAX_PLATFORMS, when set, wins (the on-card tests, marked ``gpu``, run with
JAX_PLATFORMS=cuda); otherwise the CPU is forced.  The persistent compile
cache is the package's own (deflate_jax.compile_cache_dir).
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided here, at run
    time, never at import)."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with JAX_PLATFORMS=cuda)")
