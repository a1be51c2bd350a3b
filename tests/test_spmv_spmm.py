"""SpMV / SpMM vs scipy oracles — BASELINE.json configs[0..2] correctness."""

import numpy as np
import pytest
import scipy.sparse as sps
import jax.numpy as jnp

from libhpc_tpu.sparse import CSR, BSR, ELL, COO
from libhpc_tpu.ops import spmv, spmm


def poisson2d(n):
    """5-point Poisson on an n×n grid (the BASELINE configs[0] matrix)."""
    d = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    I = sps.identity(n)
    return (sps.kron(I, d) + sps.kron(d, I)).tocsr().astype(np.float32)


@pytest.mark.parametrize("shape,density", [((1, 1), 1.0), ((13, 7), 0.3),
                                           ((100, 100), 0.05),
                                           ((297, 111), 0.1)])
def test_csr_spmv_random(rng, shape, density):
    sp = sps.random(*shape, density=density, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(7))
    x = rng.random(shape[1]).astype(np.float32)
    got = np.asarray(spmv.csr_spmv(CSR.from_scipy(sp), jnp.asarray(x)))
    np.testing.assert_allclose(got, sp @ x, rtol=1e-4, atol=1e-5)


def test_csr_spmv_poisson():
    """configs[0]: Poisson SpMV vs dense matvec."""
    A = poisson2d(32)  # 1024×1024
    x = np.linspace(-1, 1, A.shape[0]).astype(np.float32)
    csr = CSR.from_scipy(A)
    got = np.asarray(spmv.csr_spmv(csr, jnp.asarray(x)))
    dense = np.asarray(A.todense() @ x).ravel()
    np.testing.assert_allclose(got, dense, rtol=1e-4, atol=1e-4)


def test_ell_spmv(rng):
    A = poisson2d(16)
    x = rng.random(A.shape[1]).astype(np.float32)
    ell = ELL.from_scipy(A)
    got = np.asarray(spmv.ell_spmv(ell, jnp.asarray(x)))
    np.testing.assert_allclose(got, A @ x, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("block", [8, 16])
def test_bsr_spmv(rng, block):
    sp = sps.random(120, 120, density=0.05, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(3))
    x = rng.random(120).astype(np.float32)
    bsr = BSR.from_scipy(sp, block=block)
    xp = np.zeros(bsr.shape[1], np.float32)
    xp[:120] = x
    got = np.asarray(spmv.bsr_spmv(bsr, jnp.asarray(xp)))
    np.testing.assert_allclose(got[:120], sp @ x, rtol=1e-4, atol=1e-4)


def test_coo_spmv(rng):
    sp = sps.random(80, 90, density=0.1, format="coo", dtype=np.float32,
                    random_state=np.random.RandomState(5))
    x = rng.random(90).astype(np.float32)
    got = np.asarray(spmv.coo_spmv(COO.from_scipy(sp), jnp.asarray(x)))
    np.testing.assert_allclose(got, sp @ x, rtol=1e-4, atol=1e-5)


def test_matmul_operator(rng):
    sp = sps.random(50, 60, density=0.1, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(9))
    csr = CSR.from_scipy(sp)
    x = rng.random(60).astype(np.float32)
    np.testing.assert_allclose(np.asarray(csr @ jnp.asarray(x)), sp @ x,
                               rtol=1e-4, atol=1e-5)


# ---- SpMM (configs[2]) -----------------------------------------------------

@pytest.mark.parametrize("c", [1, 64])
def test_csr_spmm(rng, c):
    sp = sps.random(100, 80, density=0.08, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(11))
    B = rng.random((80, c)).astype(np.float32)
    got = np.asarray(spmm.csr_spmm(CSR.from_scipy(sp), jnp.asarray(B)))
    np.testing.assert_allclose(got, sp @ B, rtol=1e-4, atol=1e-4)


def test_ell_spmm(rng):
    A = poisson2d(10)
    B = rng.random((100, 64)).astype(np.float32)
    got = np.asarray(spmm.ell_spmm(ELL.from_scipy(A), jnp.asarray(B)))
    np.testing.assert_allclose(got, A @ B, rtol=1e-4, atol=1e-3)


def test_bsr_spmm(rng):
    sp = sps.random(64, 64, density=0.1, format="csr", dtype=np.float32,
                    random_state=np.random.RandomState(13))
    B = rng.random((64, 32)).astype(np.float32)
    got = np.asarray(spmm.bsr_spmm(BSR.from_scipy(sp, block=8),
                                   jnp.asarray(B)))
    np.testing.assert_allclose(got, sp @ B, rtol=1e-4, atol=1e-3)


# ---- DIA (zero-gather fast path) -------------------------------------------

def test_dia_roundtrip():
    A = poisson2d(12)
    from libhpc_tpu.sparse import DIA
    dia = DIA.from_scipy(A)
    np.testing.assert_allclose(np.asarray(dia.todense()), A.toarray(),
                               rtol=1e-6)
    back = dia.to_scipy()
    assert abs(back - A).max() < 1e-6


def test_dia_spmv(rng):
    from libhpc_tpu.sparse import DIA
    from libhpc_tpu.ops.spmv import dia_spmv
    A = poisson2d(16)
    x = rng.random(A.shape[1]).astype(np.float32)
    got = np.asarray(dia_spmv(DIA.from_scipy(A), jnp.asarray(x)))
    np.testing.assert_allclose(got, A @ x, rtol=1e-4, atol=1e-4)


def test_dia_spmv_nonsquare(rng):
    from libhpc_tpu.sparse import DIA
    from libhpc_tpu.ops.spmv import dia_spmv
    A = sps.random(40, 60, density=0.1, format="csr", dtype=np.float32,
                   random_state=np.random.RandomState(21))
    x = rng.random(60).astype(np.float32)
    got = np.asarray(dia_spmv(DIA.from_scipy(A), jnp.asarray(x)))
    np.testing.assert_allclose(got, A @ x, rtol=1e-4, atol=1e-4)


# ---- dtype coverage (bf16 compute path) ------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_spmv_dtypes(rng, dtype):
    import jax.numpy as jnp2

    dt = jnp2.bfloat16 if dtype == "bfloat16" else jnp2.float32
    A = poisson2d(8)
    from libhpc_tpu.sparse import DIA, ELL
    x = rng.random(A.shape[1]).astype(np.float32)
    ref = A @ x
    dia = DIA.from_scipy(A)
    import dataclasses
    dia16 = dataclasses.replace(dia, data=dia.data.astype(dt))
    got = np.asarray(spmv.dia_spmv(dia16, jnp.asarray(x).astype(dt)),
                     dtype=np.float32)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)
    ell = ELL.from_scipy(A)
    ell16 = dataclasses.replace(ell, vals=ell.vals.astype(dt))
    got = np.asarray(spmv.ell_spmv(ell16, jnp.asarray(x).astype(dt)),
                     dtype=np.float32)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


# ---- banded-hybrid (RCM + DIA band + ELL remainder) ------------------------

@pytest.mark.parametrize("rcm", [False, True])
def test_hybrid_spmv_random(rng, rcm):
    from libhpc_tpu.sparse.hybrid import BandedHybrid

    A = sps.random(150, 150, density=0.05, format="csr", dtype=np.float32,
                   random_state=np.random.RandomState(31))
    hyb = BandedHybrid.from_scipy(A, max_diags=16, rcm=rcm)
    x = rng.random(150).astype(np.float32)
    got = np.asarray(hyb @ jnp.asarray(x))
    np.testing.assert_allclose(got, A @ x, rtol=1e-4, atol=1e-4)
    assert 0.0 < hyb.coverage <= 1.0


def test_hybrid_poisson_full_coverage():
    """Poisson is fully banded: the band captures 100% and the remainder
    is empty-ish."""
    from libhpc_tpu.sparse.hybrid import BandedHybrid

    A = poisson2d(16)
    hyb = BandedHybrid.from_scipy(A, max_diags=8, rcm=False)
    assert hyb.coverage == 1.0
    x = np.linspace(0, 1, A.shape[0]).astype(np.float32)
    got = np.asarray(hyb @ jnp.asarray(x))
    np.testing.assert_allclose(got, A @ x, rtol=1e-4, atol=1e-4)


def test_hybrid_rcm_improves_coverage():
    """On a FEM-like banded-after-reordering matrix, RCM should raise band
    coverage versus the natural order under the same diagonal budget."""
    from libhpc_tpu.sparse.hybrid import BandedHybrid
    from libhpc_tpu.bench.matrices import block_random

    A = block_random(64, block=4, blocks_per_row=5, seed=7)
    # scramble with a random symmetric permutation to destroy the band
    rs = np.random.RandomState(11)
    p = rs.permutation(A.shape[0])
    A_scrambled = A[p][:, p].tocsr()
    h_plain = BandedHybrid.from_scipy(A_scrambled, max_diags=32, rcm=False)
    h_rcm = BandedHybrid.from_scipy(A_scrambled, max_diags=32, rcm=True)
    assert h_rcm.coverage > h_plain.coverage


def test_bell_spmv_matches_scipy(rng):
    import scipy.sparse as sps
    from libhpc_tpu.sparse.bell import BELL
    from libhpc_tpu.ops.spmv import bell_spmv

    A = sps.random(300, 280, density=0.03, format="csr",
                   random_state=np.random.RandomState(5)).astype(np.float32)
    bell = BELL.from_scipy(A, block=8)
    x = jnp.asarray(rng.random(bell.shape[1], dtype=np.float32))
    y = np.asarray(bell_spmv(bell, x))
    y_ref = A @ np.asarray(x)[:280]
    np.testing.assert_allclose(y[:300], y_ref, rtol=2e-4, atol=2e-4)
    # dense roundtrip
    np.testing.assert_allclose(np.asarray(bell.todense())[:300, :280],
                               A.toarray(), rtol=1e-5, atol=1e-5)


def test_bell_matmul_operator(rng):
    import scipy.sparse as sps
    from libhpc_tpu.sparse.bell import BELL

    A = sps.random(128, 128, density=0.05, format="csr",
                   random_state=np.random.RandomState(7)).astype(np.float32)
    bell = BELL.from_scipy(A, block=8)
    x = jnp.asarray(rng.random(128, dtype=np.float32))
    np.testing.assert_allclose(np.asarray(bell @ x), A @ np.asarray(x),
                               rtol=2e-4, atol=2e-4)
