"""Test fixtures.

Analog of the reference's ArrowSQLRunner (Tests/ArrowSQLRunner/
ArrowSQLRunner.h:53-84): tests run the full real engine on tiny
in-memory tables; the oracle is pandas (SQLiteComparator analog).

JAX runs on CPU with 8 virtual devices so multi-device sharding tests
run without accelerators (SURVEY.md §4.3 implication).  Checks that need
a GPU carry the ``gpu`` marker and skip, through the ``gpu_card``
fixture, where there is none.
"""

import os
import shutil
import subprocess

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture(scope="session")
def gpu_card():
    """Name of the visible NVIDIA GPU, or skip.  Asks nvidia-smi, since
    JAX in this process is held to the CPU."""
    smi = shutil.which("nvidia-smi")
    out = (subprocess.run([smi, "-L"], capture_output=True, text=True,
                          timeout=60) if smi else None)
    if out is None or out.returncode != 0 or "GPU" not in out.stdout:
        pytest.skip("no NVIDIA GPU visible")
    return out.stdout.splitlines()[0]


@pytest.fixture(scope="session")
def hdk():
    import hdk_jax

    return hdk_jax.HDK()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)
