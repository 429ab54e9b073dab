"""Test harness config: the suite runs on the CPU backend with 8 virtual
devices, so multi-device sharding paths are exercised without a GPU.

Tests that need the GPU carry the ``chip`` marker and take the
``gpu_device`` fixture, which decides at run time (never at import or
collection time) whether a GPU is present and skips with a reason when
it is not.  Run them on a GPU host with
``UPMIX_TEST_PLATFORM=gpu python -m pytest tests/ -m chip``.
"""

import os

import pytest

_ON_GPU = os.environ.get("UPMIX_TEST_PLATFORM") == "gpu"
if not _ON_GPU:
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

if not _ON_GPU:
    jax.config.update("jax_platforms", "cpu")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX sees none."""
    devices = [d for d in jax.devices() if d.platform == "gpu"]
    if not devices:
        pytest.skip("needs a GPU (run with UPMIX_TEST_PLATFORM=gpu -m chip)")
    return devices[0]
