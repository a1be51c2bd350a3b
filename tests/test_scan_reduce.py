"""Scan + reduce stage tests — numpy oracles with the reference edge-size
sweep (SURVEY.md §4.1)."""

import numpy as np
import pytest
import jax.numpy as jnp

from conftest import EDGE_SIZES
from libhpc_tpu.ops import scan, reduce as red


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_exclusive_scan(rng, n):
    x = rng.integers(0, 100, size=n).astype(np.int32)
    got = np.asarray(scan.exclusive_scan(jnp.asarray(x)))
    expect = np.cumsum(x) - x
    np.testing.assert_array_equal(got, expect)


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_exclusive_scan_f32(rng, n):
    x = rng.random(n).astype(np.float32)
    got = np.asarray(scan.exclusive_scan(jnp.asarray(x)))
    expect = (np.cumsum(x.astype(np.float64)) - x).astype(np.float32)
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)


def test_exclusive_scan_int_5000(rng):
    x = rng.integers(0, 1000, size=5000).astype(np.int32)
    got = np.asarray(scan.exclusive_scan(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.cumsum(x) - x)


@pytest.mark.parametrize("n", EDGE_SIZES)
def test_tree_reduce(rng, n):
    x = rng.integers(0, 100, size=n).astype(np.int64).astype(np.int32)
    got = int(red.tree_reduce_sum(jnp.asarray(x)))
    assert got == int(x.astype(np.int64).sum())


def test_segment_ops(rng):
    ids = rng.integers(0, 10, size=1000).astype(np.int32)
    x = rng.random(1000).astype(np.float32)
    got = np.asarray(red.segment_sum(jnp.asarray(x), jnp.asarray(ids), 10))
    expect = np.zeros(10, np.float32)
    np.sum
    for i in range(10):
        expect[i] = x[ids == i].sum()
    np.testing.assert_allclose(got, expect, rtol=1e-4)

    gmax = np.asarray(red.segment_max(jnp.asarray(x), jnp.asarray(ids), 10))
    for i in range(10):
        assert gmax[i] == x[ids == i].max()


@pytest.mark.parametrize("shape", [(1, 1), (8, 128), (100, 300), (257, 129)])
def test_row_sum_segment(rng, shape):
    """Row sums of a 2D array as a segment-sum over row ids."""
    x = rng.random(shape).astype(np.float32)
    rows = np.repeat(np.arange(shape[0], dtype=np.int32), shape[1])
    got = np.asarray(red.segment_sum(jnp.asarray(x.ravel()),
                                     jnp.asarray(rows), shape[0]))
    np.testing.assert_allclose(got, x.sum(axis=1), rtol=1e-4, atol=1e-5)
