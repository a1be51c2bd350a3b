"""Stencil tests — oracle: naive numpy sliding windows (the reference's
blur ladder semantics: sum over a(y, x±r) with zero ghost cells)."""

import numpy as np
import pytest
import jax.numpy as jnp

from libhpc_tpu.ops import stencil
from libhpc_tpu.sparse import CSR
from test_spmv_spmm import poisson2d


def naive_blur_x(a, r):
    m, n = a.shape
    ap = np.pad(a, ((0, 0), (r, r)))
    out = np.zeros_like(a)
    for dx in range(2 * r + 1):
        out += ap[:, dx : dx + n]
    return out


def naive_blur_y(a, r):
    return naive_blur_x(a.T, r).T


@pytest.mark.parametrize("shape,r", [((1, 1), 1), ((17, 33), 2),
                                     ((64, 64), 8), ((111, 297), 8)])
def test_blur_x(rng, shape, r):
    a = rng.random(shape).astype(np.float32)
    got = np.asarray(stencil.blur_x(jnp.asarray(a), r))
    np.testing.assert_allclose(got, naive_blur_x(a, r), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,r", [((17, 33), 2), ((64, 64), 8)])
def test_blur_y(rng, shape, r):
    a = rng.random(shape).astype(np.float32)
    got = np.asarray(stencil.blur_y(jnp.asarray(a), r))
    np.testing.assert_allclose(got, naive_blur_y(a, r), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape,r", [((64, 64), 8), ((100, 200), 4),
                                     ((300, 129), 8)])
def test_blur2d(rng, shape, r):
    a = rng.random(shape).astype(np.float32)
    got = np.asarray(stencil.blur2d(jnp.asarray(a), r))
    expect = naive_blur_y(naive_blur_x(a, r), r)
    np.testing.assert_allclose(got, expect, rtol=1e-3, atol=1e-3)


def test_poisson5_matches_csr(rng):
    """Matrix-free 5-point operator == the Poisson CSR SpMV (cross-check)."""
    n = 24
    A = poisson2d(n)
    u = rng.random((n, n)).astype(np.float32)
    got = np.asarray(stencil.poisson5_apply(jnp.asarray(u)))
    expect = (A @ u.ravel()).reshape(n, n)
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)


def test_poisson7_matches_csr(rng):
    from libhpc_tpu.bench.matrices import poisson3d

    n = 10
    A = poisson3d(n)
    u = rng.random((n, n, n)).astype(np.float32)
    got = np.asarray(stencil.poisson7_apply(jnp.asarray(u)))
    expect = (A @ u.ravel()).reshape(n, n, n)
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)
