"""Test harness configuration.

Unit/integration tests run on CPU with a virtual 8-device mesh so that
multi-chip sharding paths compile and execute without accelerator
hardware (the reference's analog is its hardware-free test binary,
tests/run_tests.sh + Makefile:43-44). The GPU path is checked by
chip_smoke.py on the card instead, which does not import this file.
"""

import os

# Force CPU before the backend initializes. jax.config.update is
# authoritative even when jax was imported before this file ran.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the vmapped decode pipeline is a large
# CPU compile; cache it across test processes.
from rtlsdr_wsprd_tpu import compile_cache  # noqa: E402

compile_cache.enable()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_DIR = "/root/reference"
REF_GOLDEN_IQ = os.path.join(REFERENCE_DIR, "signals", "refSignalSnr0dB.iq")


@pytest.fixture(scope="session")
def golden_iq_path():
    if not os.path.exists(REF_GOLDEN_IQ):
        pytest.skip("reference golden capture not available")
    return REF_GOLDEN_IQ


@pytest.fixture()
def rng():
    return np.random.default_rng(20260816)
