"""Block (BSR) SpGEMM tests.

Oracle: scipy csr matmul on the padded operands, exactly the strategy of
the scalar SpGEMM suite (test_solver_spgemm.py) and the reference's
stage-vs-CPU-oracle style (SURVEY.md §4.1)."""

import numpy as np
import pytest
import scipy.sparse as sps

from libhpc_tpu.ops.spgemm_bsr import spgemm_bsr
from libhpc_tpu.sparse.bsr import BSR
from test_spmv_spmm import poisson2d


def _check(A_sp, B_sp, **kw):
    A = BSR.from_scipy(A_sp)
    B = BSR.from_scipy(B_sp)
    C = spgemm_bsr(A, B, **kw)
    got = C.to_scipy().tocsr()
    ref = (sps.csr_matrix(A.to_scipy()) @ sps.csr_matrix(B.to_scipy())
           ).tocsr()
    # block symbolic covers every scipy nonzero (may store extra explicit
    # zeros from block fill-in); values must match everywhere
    d = abs(got - ref)
    assert (d.max() if d.nnz else 0.0) < 1e-4 * max(abs(ref).max(), 1.0)


@pytest.mark.parametrize("m,k,n,da,db", [
    (64, 64, 64, 0.1, 0.1),
    (200, 160, 240, 0.05, 0.08),      # non-multiple-of-8 shapes
    (1, 1, 1, 1.0, 1.0),              # reference edge-size style
    (111, 297, 113, 0.2, 0.2),
])
def test_spgemm_bsr_random(m, k, n, da, db):
    A = sps.random(m, k, density=da, random_state=1, format="csr",
                   dtype=np.float32)
    B = sps.random(k, n, density=db, random_state=2, format="csr",
                   dtype=np.float32)
    _check(A, B)


def test_spgemm_bsr_square_random():
    A = sps.random(128, 128, density=0.1, random_state=3, format="csr",
                   dtype=np.float32)
    _check(A, A)


def test_spgemm_bsr_pair_chunking():
    """Chunk boundaries mid-segment must still sum exactly (partial
    segment sums add)."""
    A = poisson2d(24)  # 576x576, blocks straddle rows
    _check(A, A, pair_chunk=1000)


def test_spgemm_bsr_poisson_vs_scalar():
    """Block and scalar SpGEMM agree on the same product."""
    from libhpc_tpu.ops.spgemm import spgemm_csr
    from libhpc_tpu.sparse import CSR

    A = poisson2d(20)
    C_blk = spgemm_bsr(BSR.from_scipy(A), BSR.from_scipy(A)).to_scipy()
    C_sc = spgemm_csr(CSR.from_scipy(A), CSR.from_scipy(A)).to_scipy()
    d = abs(C_blk.tocsr()[:400, :400] - C_sc.tocsr()[:400, :400])
    assert (d.max() if d.nnz else 0.0) < 1e-5


def test_spgemm_bsr_empty():
    A = sps.csr_matrix((64, 64), dtype=np.float32)
    B = sps.random(64, 64, density=0.1, random_state=4, format="csr",
                   dtype=np.float32)
    C = spgemm_bsr(BSR.from_scipy(A), BSR.from_scipy(B))
    assert abs(C.to_scipy()).max() == 0.0


def test_spgemm_bsr_rectangular_blocks_mismatch():
    A = BSR.from_scipy(sps.identity(64, format="csr", dtype=np.float32),
                       block=8)
    B = BSR.from_scipy(sps.identity(64, format="csr", dtype=np.float32),
                       block=4)
    with pytest.raises(ValueError):
        spgemm_bsr(A, B)


def test_bsr_to_scipy_stays_sparse():
    """to_scipy builds from the blocks: a 1.6M x 1.6M operator with a few
    blocks (a dense image would need ~10 TB) converts, duplicates summed
    and zeros dropped."""
    import jax.numpy as jnp

    n = 8 * 200_000
    blocks = np.zeros((3, 8, 8), np.float32)
    blocks[0, 1, 2] = 1.5
    blocks[1, 1, 2] = 2.0            # same block (0, 7) again: summed
    blocks[2, 0, 0] = -1.0
    indptr = np.zeros(n // 8 + 1, np.int32)
    indptr[1:] = 2
    indptr[-1] = 3
    A = BSR(blocks=jnp.asarray(blocks),
            indices=jnp.asarray(np.array([7, 7, 199_999], np.int32)),
            indptr=jnp.asarray(indptr), shape=(n, n))
    S = A.to_scipy()
    assert S.shape == (n, n) and S.nnz == 2
    assert S[1, 7 * 8 + 2] == 3.5
    assert S[n - 8, n - 8] == -1.0
