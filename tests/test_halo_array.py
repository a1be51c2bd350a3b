"""HaloArray container tests.

Mirrors the reference's HPCHighDimensionFlatArray behavior
(lib/hpc/include/HPCHighDimensionFlatArray.hpp): negative indices address
the halo, checked access raises on out-of-bounds, and stencil access works
identically whether the ghost cells are constant-filled (single chip) or
exchange-filled (distributed).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from libhpc_tpu.containers import HaloArray


def test_wrap_and_interior(rng):
    x = rng.random((6, 10)).astype(np.float32)
    h = HaloArray.wrap(jnp.asarray(x), lo=(2, 3), hi=(1, 0), fill=7.0)
    assert h.data.shape == (9, 13)
    assert h.interior_shape == (6, 10)
    np.testing.assert_array_equal(np.asarray(h.interior), x)
    # ghost cells carry the fill value
    assert float(h.data[0, 5]) == 7.0
    assert float(h.data[-1, 5]) == 7.0


def test_negative_index_window(rng):
    x = rng.random((4, 8)).astype(np.float32)
    h = HaloArray.wrap(jnp.asarray(x), 2, fill=-1.0)
    # window reaching into the low halo (negative start = ghost reads)
    w = np.asarray(h.window((-2, 0), (3, 8)))
    assert np.all(w[:2] == -1.0)
    np.testing.assert_array_equal(w[2], x[0])


def test_shift_is_stencil_access(rng):
    x = rng.random((5, 7)).astype(np.float32)
    h = HaloArray.wrap(jnp.asarray(x), 1)
    up = np.asarray(h.shift((-1, 0)))
    np.testing.assert_array_equal(up[1:], x[:-1])  # a(y-1, x)
    assert np.all(up[0] == 0.0)


def test_checked_bounds():
    h = HaloArray.wrap(jnp.zeros((4, 4)), 1)
    with pytest.raises(IndexError):
        h.window((-2, 0), (4, 4))     # beyond the low halo
    with pytest.raises(IndexError):
        h.shift((0, 2))               # beyond the high halo


def test_with_interior_keeps_ghosts(rng):
    x = rng.random((3, 3)).astype(np.float32)
    h = HaloArray.wrap(jnp.asarray(x), 1, fill=5.0)
    h2 = h.with_interior(jnp.zeros((3, 3), jnp.float32))
    assert float(h2.data[0, 0]) == 5.0
    assert np.all(np.asarray(h2.interior) == 0.0)
    with pytest.raises(ValueError):
        h.with_interior(jnp.zeros((2, 3), jnp.float32))


def test_set_halo_slab(rng):
    x = rng.random((4, 6)).astype(np.float32)
    h = HaloArray.wrap(jnp.asarray(x), (1, 0))
    ghost = jnp.full((1, 6), 9.0)
    h2 = h.set_halo(0, "lo", ghost).set_halo(0, "hi", ghost * 2)
    assert np.all(np.asarray(h2.data[0]) == 9.0)
    assert np.all(np.asarray(h2.data[-1]) == 18.0)
    np.testing.assert_array_equal(np.asarray(h2.interior), x)


def test_shared_kernel_zero_vs_filled_halo(rng):
    """The same poisson5_halo kernel under both ghost policies: zero halo
    equals the classic padded formula; nonzero ghosts change only rim rows
    (what a ppermute exchange would supply)."""
    from libhpc_tpu.ops.stencil import poisson5_halo

    x = rng.random((6, 6)).astype(np.float32)
    h0 = HaloArray.wrap(jnp.asarray(x), 1)
    y0 = np.asarray(poisson5_halo(h0))
    xp = np.pad(x, 1)
    expect = (4 * x - xp[:-2, 1:-1] - xp[2:, 1:-1]
              - xp[1:-1, :-2] - xp[1:-1, 2:])
    np.testing.assert_allclose(y0, expect, rtol=1e-6)

    h1 = h0.set_halo(0, "lo", jnp.ones((1, 8), jnp.float32))
    y1 = np.asarray(poisson5_halo(h1))
    np.testing.assert_allclose(y1[1:], y0[1:], rtol=1e-6)
    np.testing.assert_allclose(y1[0], y0[0] - 1.0, rtol=1e-5)
