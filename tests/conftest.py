"""Test configuration.

Tests run on the CPU with an emulated 8-device mesh (multi-device paths
without a cluster) and float64 enabled so golden-parity comparisons
against the float64 numpy reference are meaningful.

Tests marked ``gpu`` need an NVIDIA GPU and skip elsewhere; on the card
run them with ``TPUNMF_TEST_GPU=1 python -m pytest tests -m gpu``, which
leaves JAX on its default platform instead of forcing the CPU.  The
platform is set through jax.config before the first backend starts.
"""
import os
import sys

import jax

if not os.environ.get("TPUNMF_TEST_GPU"):
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REFERENCE_PATH = "/root/reference"
HAS_REFERENCE = os.path.isdir(os.path.join(REFERENCE_PATH, "nmf"))
if HAS_REFERENCE and REFERENCE_PATH not in sys.path:
    sys.path.insert(0, REFERENCE_PATH)

requires_reference = pytest.mark.skipif(
    not HAS_REFERENCE, reason="reference package not available at /root/reference"
)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def lowrank_data(rng):
    """Small dense non-negative matrix with exact low rank + noise floor."""
    w = rng.random((60, 5))
    h = rng.random((5, 48))
    return (w @ h + 0.01 * rng.random((60, 48))).astype(np.float64)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none.  Decided
    here, at run time, never at import (every xdist worker must collect
    the same tests)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (found {dev.platform})")
    return dev
