"""Test configuration: force an 8-virtual-device CPU platform.

All tests run on CPU with 8 virtual devices so multi-device sharding
(mesh/all_to_all/shard_map paths) is exercised without accelerator
hardware, per the distributed test strategy (SURVEY.md section 4, point
4).  Must be set before jax initializes.

Tests that need a GPU carry the `chip` marker and take the `gpu_env`
fixture, which skips them where no card is present.  They run on the
card with `python -m pytest -m chip tests/`.
"""

import os
import shutil
import subprocess

import pytest

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a GPU; run on the card with -m chip")


@pytest.fixture
def gpu_env():
    """Environment for a child process that uses the GPU (this process
    is held to the CPU); skips the test when nvidia-smi finds no card."""
    smi = shutil.which("nvidia-smi")
    if smi is None:
        pytest.skip("no GPU: nvidia-smi not found")
    out = subprocess.run([smi, "-L"], capture_output=True, text=True)
    if out.returncode != 0 or "GPU" not in out.stdout:
        pytest.skip("no GPU: nvidia-smi lists no card")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    return env
