"""Test harness: CPU backend with 8 virtual devices, float64 enabled.

Multi-device tests use the fake-mesh pattern the reference entirely lacks
(SURVEY.md section 4): XLA_FLAGS=--xla_force_host_platform_device_count=8.

The backend defaults to the CPU.  Tests marked ``gpu`` need the card and
skip elsewhere; run them on a GPU host with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest

from stabilized_navier_stokes_flow_fenicsx.utils.compile_cache import (
    enable_compile_cache)

enable_compile_cache()
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX has none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/")
    return dev
