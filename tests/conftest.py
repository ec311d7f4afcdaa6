# coding=utf-8
"""Test configuration: an 8-device virtual CPU mesh by default.

Tests run on the CPU unless ``JAX_PLATFORMS`` says otherwise — sharding
logic runs on a fake 8-device CPU mesh (the standard JAX trick, SURVEY.md
§4).  Tests marked ``gpu`` need the card and skip elsewhere (the
``gpu_devices`` fixture decides at run time).  Must set flags before jax
import.
"""

import os
import sys

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in xla_flags:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_numpy_rank_promotion", "raise")


@pytest.fixture
def gpu_devices():
    """The GPU devices, or a skip when JAX runs on anything else."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {devices[0].platform}")
    return devices
