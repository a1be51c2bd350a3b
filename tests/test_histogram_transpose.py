"""Histogram + transpose stage tests, incl. padding-invariance variants
(the reference's IgnoresPadding pattern, SURVEY.md §4.1)."""

import numpy as np
import pytest
import jax.numpy as jnp

from conftest import EDGE_SIZES
from libhpc_tpu.ops import histogram as hist, transpose as tr


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_histogram(rng, n):
    x = rng.integers(0, 256, size=n).astype(np.int32)
    got = np.asarray(hist.histogram(jnp.asarray(x), 256))
    np.testing.assert_array_equal(got, np.bincount(x, minlength=256))


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_histogram_ignores_padding(rng, n):
    """Pad handling: values equal to n_bins (the pad value the tiled
    stages use) are not counted; the total is the in-range count."""
    x = rng.integers(0, 257, size=n).astype(np.int32)
    got = np.asarray(hist.histogram(jnp.asarray(x), 256))
    np.testing.assert_array_equal(got, np.bincount(x[x < 256],
                                                   minlength=256))
    assert got.sum() == int((x < 256).sum())


@pytest.mark.parametrize("n", [1, 111, 3987])
def test_local_histogram(rng, n):
    x = rng.integers(0, 16, size=n).astype(np.int32)
    tile = 256
    got = np.asarray(hist.local_histogram(jnp.asarray(x), 16, tile=tile))
    n_tiles = max(1, -(-n // tile))
    assert got.shape == (n_tiles, 16)
    for t in range(n_tiles):
        seg = x[t * tile : (t + 1) * tile]
        np.testing.assert_array_equal(got[t], np.bincount(seg, minlength=16))
    assert got.sum() == n  # padding not counted


@pytest.mark.parametrize("shape", [(1, 1), (128, 128), (100, 300),
                                   (257, 513), (512, 128)])
def test_transpose(rng, shape):
    x = rng.random(shape).astype(np.float32)
    got = np.asarray(tr.transpose(jnp.asarray(x)))
    np.testing.assert_array_equal(got, x.T)


def test_transpose_int(rng):
    x = rng.integers(0, 1000, size=(130, 260)).astype(np.int32)
    got = np.asarray(tr.transpose(jnp.asarray(x)))
    np.testing.assert_array_equal(got, x.T)


# ---- dense matmul (blocked-matmul workload parity) ------------------

@pytest.mark.parametrize("shape", [((8, 8), (8, 8)), ((100, 200), (200, 50)),
                                   ((256, 512), (512, 256)),
                                   ((300, 300), (300, 300))])
def test_matmul(rng, shape):
    from libhpc_tpu.ops.matmul import matmul

    (am, ak), (bk, bn) = shape
    a = rng.random((am, ak)).astype(np.float32)
    b = rng.random((bk, bn)).astype(np.float32)
    got = np.asarray(matmul(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, a @ b, rtol=1e-4, atol=1e-3)
