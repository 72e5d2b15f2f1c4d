"""Test configuration: JAX on an 8-device virtual CPU mesh.

Kernel tests run on ``platform=cpu`` with a faked mesh (SURVEY.md section
4); Pallas kernels run in interpret mode there.  Tests that need a CUDA
GPU carry the ``gpu`` marker and take the ``gpu_device`` fixture, which
skips them on the CPU backend.
"""

import os
import sys

import pytest

_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

try:
    jax.config.update("jax_platforms", "cpu")
except Exception:
    pass  # a backend is already up (e.g. user-forced); leave it alone

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test on any other backend."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs this path there")
    return jax.devices()[0]
