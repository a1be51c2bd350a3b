"""AMG-on-SBELL tests: the V-cycle smooths through the
pane-resident SBELL matvec; oracles are scipy direct solves."""

import numpy as np
import pytest
import scipy.sparse as sps

import jax.numpy as jnp

from libhpc_tpu.bench import matrices
from libhpc_tpu.ops import multigrid_sbell as amg
from libhpc_tpu.ops.spmv_pallas import sbell_spmv


def _fem_spd(n_block_rows=200, seed=31):
    """SPD-ified FEM-like block matrix: symmetrize + make diagonally
    dominant (the synthetic stand-in for cant's SPD structure)."""
    B = matrices.block_random(n_block_rows, block=8, blocks_per_row=5,
                              seed=seed, half_band=4, far_fraction=0.02)
    A = (B + B.T).tocsr()
    rowsum = np.abs(A).sum(axis=1).A1 if hasattr(
        np.abs(A).sum(axis=1), "A1") else np.asarray(
            np.abs(A).sum(axis=1)).ravel()
    A = A + sps.diags(rowsum + 1.0)
    return A.tocsr().astype(np.float32)


def test_aggregate_partitions():
    A = matrices.poisson2d(32)
    agg, nc = amg._aggregate(A, theta=0.08)
    assert agg.min() == 0 and agg.max() == nc - 1
    assert np.all(np.bincount(agg) >= 1)
    # aggregation actually coarsens (cross-shaped aggregates on Poisson)
    assert nc < A.shape[0] / 2


def test_amg_vcycle_contracts_poisson():
    A = matrices.poisson2d(64)      # 4096 rows
    H = amg.amg_setup(A, n_levels=2, coarse_max=1500)
    assert len(H.levels) == 1
    rng = np.random.default_rng(0)
    b = jnp.asarray(rng.standard_normal(A.shape[0]).astype(np.float32))
    x1 = amg.amg_vcycle(H, b)
    r1 = np.asarray(b) - A @ np.asarray(x1)
    assert np.linalg.norm(r1) < 0.8 * np.linalg.norm(np.asarray(b))


def test_amg_pcg_poisson_matches_direct():
    import scipy.sparse.linalg as spla

    A = matrices.poisson2d(64)
    H = amg.amg_setup(A, n_levels=2, coarse_max=1500)
    sb = H.levels[0].sbell
    n = A.shape[0]
    rng = np.random.default_rng(1)
    b = rng.standard_normal(n).astype(np.float32)
    x, it, res2 = amg.amg_pcg(H, lambda v: sbell_spmv(sb, v),
                              jnp.asarray(b), tol=1e-6, max_iter=100)
    expect = spla.spsolve(A.tocsc().astype(np.float64),
                          b.astype(np.float64))
    np.testing.assert_allclose(np.asarray(x), expect, rtol=2e-3, atol=2e-3)
    # and it beats plain CG in iteration count
    from libhpc_tpu.ops import solver

    _, it_cg, _ = solver.cg(lambda v: sbell_spmv(sb, v), jnp.asarray(b),
                            tol=1e-6, max_iter=1000)
    assert int(it) < int(it_cg) / 2


def test_amg_pcg_fem_spd():
    import scipy.sparse.linalg as spla

    A = _fem_spd()
    H = amg.amg_setup(A, n_levels=2, coarse_max=800)
    sb = H.levels[0].sbell
    n = A.shape[0]
    rng = np.random.default_rng(2)
    b = rng.standard_normal(n).astype(np.float32)
    x, it, res2 = amg.amg_pcg(H, lambda v: sbell_spmv(sb, v),
                              jnp.asarray(b), tol=1e-6, max_iter=200)
    expect = spla.spsolve(A.tocsc().astype(np.float64),
                          b.astype(np.float64))
    np.testing.assert_allclose(np.asarray(x), expect, rtol=2e-3, atol=2e-3)


def test_amg_smoothed_aggregation_fewer_iters():
    """Smoothed-aggregation P cuts PCG iterations vs piecewise-constant
    on Poisson (the textbook SA payoff)."""
    import scipy.sparse.linalg as spla

    A = matrices.poisson2d(64)
    rng = np.random.default_rng(3)
    b = rng.standard_normal(A.shape[0]).astype(np.float32)
    H0 = amg.amg_setup(A, n_levels=2, coarse_max=1500)
    H1 = amg.amg_setup(A, n_levels=2, coarse_max=1500, smooth_p=True)
    sb = H0.levels[0].sbell
    x0, it0, _ = amg.amg_pcg(H0, lambda v: sbell_spmv(sb, v),
                             jnp.asarray(b), tol=1e-6, max_iter=100)
    x1, it1, _ = amg.amg_pcg(H1, lambda v: sbell_spmv(sb, v),
                             jnp.asarray(b), tol=1e-6, max_iter=100)
    expect = spla.spsolve(A.tocsc().astype(np.float64),
                          b.astype(np.float64))
    np.testing.assert_allclose(np.asarray(x1), expect, rtol=2e-3,
                               atol=2e-3)
    assert int(it1) < int(it0)


def test_amg_setup_rejects_invalid_sweeps():
    """pre/post validation: pre=0 silently behaved as pre=1,
    and pre != post breaks the SPD property pcg_op relies on."""
    import pytest

    A = matrices.poisson2d(32)
    with pytest.raises(ValueError, match="must be >= 1"):
        amg.amg_setup(A, n_levels=2, pre=0, post=0)
    with pytest.raises(ValueError, match="non-symmetric"):
        amg.amg_setup(A, n_levels=2, pre=1, post=2)
