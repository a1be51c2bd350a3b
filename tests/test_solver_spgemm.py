"""CG solver + SpGEMM tests (BASELINE.json configs[2], configs[4])."""

import numpy as np
import pytest
import scipy.sparse as sps
import jax.numpy as jnp

from libhpc_tpu.sparse import CSR
from libhpc_tpu.ops import solver, spgemm
from test_spmv_spmm import poisson2d


def test_cg_poisson():
    A = poisson2d(16)  # 256×256 SPD
    csr = CSR.from_scipy(A)
    rng = np.random.default_rng(0)
    x_true = rng.random(A.shape[0]).astype(np.float32)
    b = jnp.asarray(A @ x_true)
    x, it, res = solver.cg(lambda v: csr @ v, b, tol=1e-5, max_iter=2000)
    assert int(it) < 2000
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-2, atol=1e-2)


def test_cg_matrix_free():
    """Matrix-free operator (stencil) gives the same answer as the CSR CG."""
    from libhpc_tpu.ops.stencil import poisson5_apply

    n = 16
    A = poisson2d(n)
    csr = CSR.from_scipy(A)
    rng = np.random.default_rng(1)
    b_grid = rng.random((n, n)).astype(np.float32)
    b = jnp.asarray(b_grid.ravel())

    x1, _, _ = solver.cg(lambda v: csr @ v, b, tol=1e-6, max_iter=2000)
    mv = lambda v: poisson5_apply(v.reshape(n, n)).ravel()
    x2, _, _ = solver.cg(mv, b, tol=1e-6, max_iter=2000)
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x2), rtol=1e-3,
                               atol=1e-3)


def test_jacobi_smoother():
    A = poisson2d(8)
    csr = CSR.from_scipy(A)
    diag = jnp.asarray(A.diagonal().astype(np.float32))
    rng = np.random.default_rng(2)
    x_true = rng.random(A.shape[0]).astype(np.float32)
    b = jnp.asarray(A @ x_true)
    x = solver.jacobi(lambda v: csr @ v, diag, b, n_iter=2000, omega=0.8)
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=0.05, atol=0.05)


# ---- SpGEMM ----------------------------------------------------------------

@pytest.mark.parametrize("m,k,n,da,db", [(1, 1, 1, 1.0, 1.0),
                                         (20, 30, 25, 0.2, 0.2),
                                         (64, 64, 64, 0.05, 0.05),
                                         (111, 97, 113, 0.1, 0.08)])
def test_spgemm_random(m, k, n, da, db):
    rs = np.random.RandomState(42)
    A = sps.random(m, k, density=da, format="csr", dtype=np.float32,
                   random_state=rs)
    B = sps.random(k, n, density=db, format="csr", dtype=np.float32,
                   random_state=rs)
    C = spgemm.spgemm(CSR.from_scipy(A), CSR.from_scipy(B))
    np.testing.assert_allclose(np.asarray(C.todense()), (A @ B).toarray(),
                               rtol=1e-4, atol=1e-4)


def test_spgemm_csr_poisson():
    A = poisson2d(8)
    C = spgemm.spgemm_csr(CSR.from_scipy(A), CSR.from_scipy(A))
    np.testing.assert_allclose(np.asarray(C.todense()), (A @ A).toarray(),
                               rtol=1e-4, atol=1e-4)


def test_spgemm_expansion_size():
    A = poisson2d(4)
    got = spgemm.spgemm_expansion_size(CSR.from_scipy(A), CSR.from_scipy(A))
    lenB = np.diff(A.indptr)
    expect = int(lenB[A.indices].sum())
    assert got == expect


def test_pcg_poisson():
    """Jacobi-PCG converges and in no more iterations than plain CG."""
    A = poisson2d(16)
    csr = CSR.from_scipy(A)
    diag = jnp.asarray(A.diagonal().astype(np.float32))
    rng = np.random.default_rng(3)
    x_true = rng.random(A.shape[0]).astype(np.float32)
    b = jnp.asarray(A @ x_true)
    x1, it1, _ = solver.cg(lambda v: csr @ v, b, tol=1e-5, max_iter=2000)
    x2, it2, _ = solver.pcg(lambda v: csr @ v, diag, b, tol=1e-5,
                            max_iter=2000)
    assert int(it2) <= int(it1) + 2
    np.testing.assert_allclose(np.asarray(x2), x_true, rtol=1e-2, atol=1e-2)


def test_spmv_transpose(rng):
    from libhpc_tpu.ops.spmv import csr_spmv_t, dia_spmv_t
    from libhpc_tpu.sparse import DIA

    A = sps.random(60, 80, density=0.1, format="csr", dtype=np.float32,
                   random_state=np.random.RandomState(19))
    y = rng.random(60).astype(np.float32)
    expect = A.T @ y
    got = np.asarray(csr_spmv_t(CSR.from_scipy(A), jnp.asarray(y)))
    np.testing.assert_allclose(got, expect, rtol=1e-4, atol=1e-4)
    # DIA transpose on a banded matrix (DIA's intended domain; a dense
    # random pattern would trip the MAX_DIA_OFFSETS compile-safety guard)
    Ab = sps.diags([rng.random(59), rng.random(60), rng.random(60)],
                   [-1, 0, 3], shape=(60, 80), format="csr",
                   dtype=np.float32)
    expect_b = Ab.T @ y
    got = np.asarray(dia_spmv_t(DIA.from_scipy(Ab), jnp.asarray(y)))
    np.testing.assert_allclose(got, expect_b, rtol=1e-4, atol=1e-4)


def test_dia_offset_guard():
    """A quasi-structured matrix (many distinct diagonals) must be rejected
    by dia_spmv instead of compile-bombing."""
    from libhpc_tpu.ops.spmv import MAX_DIA_OFFSETS, dia_spmv
    from libhpc_tpu.sparse import DIA

    n = MAX_DIA_OFFSETS + 32
    A = sps.diags([np.ones(n - k) for k in range(n)], list(range(n)),
                  shape=(n, n), format="csr", dtype=np.float32)
    dia = DIA.from_scipy(A)
    with pytest.raises(ValueError, match="compile-safety cap"):
        dia_spmv(dia, jnp.ones(n, jnp.float32))


@pytest.mark.parametrize("row_block", [7, 32, 1000])
def test_spgemm_blocked(row_block):
    rs = np.random.RandomState(23)
    A = sps.random(90, 70, density=0.1, format="csr", dtype=np.float32,
                   random_state=rs)
    B = sps.random(70, 85, density=0.1, format="csr", dtype=np.float32,
                   random_state=rs)
    C = spgemm.spgemm_blocked(CSR.from_scipy(A), CSR.from_scipy(B),
                              row_block=row_block)
    np.testing.assert_allclose(np.asarray(C.todense()), (A @ B).toarray(),
                               rtol=1e-4, atol=1e-4)


def test_bicgstab_nonsymmetric(rng):
    """BiCGSTAB solves a nonsymmetric convection-diffusion-like system that
    plain CG cannot."""
    n = 24
    # upwind convection + diffusion: tridiagonal, nonsymmetric
    main = np.full(n * n, 4.2, np.float32)
    A = poisson2d(n).tolil().astype(np.float32)
    for i in range(n * n - 1):
        A[i, i + 1] = A[i, i + 1] - 0.3  # convective bias
    A = A.tocsr()
    csr = CSR.from_scipy(A)
    x_true = rng.random(n * n).astype(np.float32)
    b = jnp.asarray(A @ x_true)
    x, it, res = solver.bicgstab(lambda v: csr @ v, b, tol=1e-6,
                                 max_iter=3000)
    assert int(it) < 3000
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("window", [64, 257, 1 << 12])
def test_spgemm_windowed(window):
    """Exact-expansion windowed SpGEMM vs scipy, incl. multi-window seams,
    empty B rows (zero-length sources), and rectangular shapes."""
    rs = np.random.RandomState(7)
    A = sps.random(120, 90, density=0.08, format="csr", dtype=np.float32,
                   random_state=rs)
    B = sps.random(90, 105, density=0.07, format="csr", dtype=np.float32,
                   random_state=rs)
    # force some empty B rows
    B = B.tolil()
    B[3, :] = 0
    B[40, :] = 0
    B = B.tocsr()
    B.eliminate_zeros()
    C = spgemm.spgemm_windowed(CSR.from_scipy(A), CSR.from_scipy(B),
                               window=window)
    ref = (A @ B).toarray()
    np.testing.assert_allclose(np.asarray(C.todense()), ref,
                               rtol=1e-4, atol=1e-4)
    # canonical: exact nnz, no duplicates
    Csp = sps.csr_matrix((A @ B))
    Csp.eliminate_zeros()
    got = C.to_scipy().tocsr()
    got.eliminate_zeros()
    assert got.nnz == Csp.nnz


def test_spgemm_windowed_poisson_identity():
    A = poisson2d(16)
    I = sps.identity(A.shape[0], format="csr", dtype=np.float32)
    C = spgemm.spgemm_windowed(CSR.from_scipy(A), CSR.from_scipy(I),
                               window=500)
    np.testing.assert_allclose(np.asarray(C.todense()), A.toarray(),
                               rtol=1e-5, atol=1e-5)


def test_spgemm_windowed_empty_product():
    """A whose columns all hit empty B rows -> zero matrix."""
    A = sps.csr_matrix(np.array([[1.0, 0.0], [0.0, 2.0]], np.float32))
    B = sps.csr_matrix(np.zeros((2, 3), np.float32))
    C = spgemm.spgemm_windowed(CSR.from_scipy(A), CSR.from_scipy(B))
    assert C.shape == (2, 3)
    assert float(jnp.sum(jnp.abs(C.data))) == 0.0
