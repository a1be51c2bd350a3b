"""Distributed AMG-PCG on the 8-virtual-device CPU mesh."""

import numpy as np
import pytest
import scipy.sparse as sps

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from libhpc_tpu.bench import matrices
from libhpc_tpu.parallel.dist_amg import dist_amg_pcg


@pytest.fixture
def mesh():
    devs = np.array(jax.devices()[:8])
    return Mesh(devs, ("x",))


def _fem_spd(n_block_rows=260, seed=17):
    B = matrices.block_random(n_block_rows, block=8, blocks_per_row=5,
                              seed=seed, half_band=4, far_fraction=0.02)
    A = (B + B.T).tocsr()
    rowsum = np.asarray(np.abs(A).sum(axis=1)).ravel()
    return (A + sps.diags(rowsum + 1.0)).tocsr().astype(np.float32)


def test_dist_amg_pcg_poisson(mesh):
    import scipy.sparse.linalg as spla

    A = matrices.poisson2d(64)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.shape[0]).astype(np.float32)
    x, it, res2 = dist_amg_pcg(A, mesh, 8, b, tol=1e-6, max_iter=100)
    xs = np.asarray(x)[:A.shape[0]]
    expect = spla.spsolve(A.tocsc().astype(np.float64),
                          b.astype(np.float64))
    np.testing.assert_allclose(xs, expect, rtol=2e-3, atol=2e-3)
    # the preconditioner must actually work: far fewer than CG-alone iters
    assert int(it) < 40


def test_dist_amg_pcg_fem_spd(mesh):
    import scipy.sparse.linalg as spla

    A = _fem_spd()
    rng = np.random.default_rng(1)
    b = rng.standard_normal(A.shape[0]).astype(np.float32)
    x, it, res2 = dist_amg_pcg(A, mesh, 8, b, tol=1e-6, max_iter=100)
    xs = np.asarray(x)[:A.shape[0]]
    expect = spla.spsolve(A.tocsc().astype(np.float64),
                          b.astype(np.float64))
    np.testing.assert_allclose(xs, expect, rtol=2e-3, atol=2e-3)


def test_dist_amg_pcg_larger_fine_level(mesh):
    """Distributed AMG-PCG on a 24k-row operator: the fine-level
    DistSBELL matvec under shard_map under pcg_op's while_loop."""
    import scipy.sparse.linalg as spla

    A = _fem_spd(n_block_rows=3000, seed=23)
    rng = np.random.default_rng(2)
    b = rng.standard_normal(A.shape[0]).astype(np.float32)
    x, it, res2 = dist_amg_pcg(A, mesh, 8, b, tol=1e-6, max_iter=100)
    xs = np.asarray(x)[:A.shape[0]]
    expect = spla.spsolve(A.tocsc().astype(np.float64),
                          b.astype(np.float64))
    np.testing.assert_allclose(xs, expect, rtol=2e-3, atol=2e-3)
