"""Test configuration.

Tests run on 8 virtual CPU devices (multi-device simulation, SURVEY.md
§4.6) unless LIBHPC_TEST_GPU=1, in which case JAX keeps its GPU backend
and the `gpu`-marked tests run (chip_smoke.py does this in-process). The
platform choice MUST run before any jax backend initialization.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

if os.environ.get("LIBHPC_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
else:
    from libhpc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The GPU device for `gpu`-marked tests; skips when there is none.
    Decided here, at run time — never while a module is imported, so
    every xdist worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA GPU (default device is {dev.platform})")
    return dev


# the reference's deliberate edge-size sweep
# (test_radix_local_count.cu:199-201): sub-tile, non-multiples, multi-tile
EDGE_SIZES = [1, 111, 256, 297, 500, 512, 3987, 1024 * 256 + 57]


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running test")
    config.addinivalue_line(
        "markers", "gpu: runs compiled kernels on a CUDA GPU (skips "
        "elsewhere; run with LIBHPC_TEST_GPU=1 or chip_smoke.py)")
