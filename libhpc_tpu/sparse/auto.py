"""Automatic format selection — one entry point for "just give me a fast
matvec" users migrating from the reference's format-per-structure zoo
(SURVEY.md §2.3-2.7; docs/MIGRATION.md).

Routes, in order:
  * few distinct, well-filled diagonals -> DIA: shifted multiply-adds that
    XLA fuses into one elementwise pass at any size;
  * 8x8-block-dense (FEM-class) -> SBELL, the flagship block path (the
    Triton kernel on a GPU; bf16 value stream optional);
  * scalar-regular rows (ELL rectangle, k padded to 8, k*m <= 4*nnz) ->
    ELL: one dense gather of x and a row sum;
  * everything else -> CSR: gather + segment-sum over the stored entries.
"""

from __future__ import annotations

import numpy as np

_DIA_MAX_OFFSETS = 96          # matches ops/spmv.py MAX_DIA_OFFSETS


def auto_format(A, prefer_bf16: bool = False):
    """Pick a container + matvec for a scipy sparse matrix.

    Returns (container, matvec) where matvec(container, x) -> y and the
    container is one of DIA / SBELL / ELL / CSR."""
    import scipy.sparse as sps

    A = sps.csr_matrix(A)
    m, n = A.shape

    # --- structured? count distinct diagonals ---------------------------
    # gate on diagonal FILL too: a scatter of nnz along <=96 long offsets
    # would build a dense m*D DIA container streaming orders of magnitude
    # more bytes per matvec than the sparse routes; require each stored
    # diagonal to be ~quarter-populated on average before paying for the
    # rectangle
    coo = A.tocoo()
    diags = np.unique(coo.col.astype(np.int64) - coo.row)
    dia_fill_ok = A.nnz >= 0.25 * diags.size * min(m, n)
    if diags.size <= _DIA_MAX_OFFSETS and dia_fill_ok:
        from libhpc_tpu.ops.spmv import dia_spmv
        from libhpc_tpu.sparse.dia import DIA

        return DIA.from_scipy(A), dia_spmv

    # --- 8x8-block-dense (FEM-class)? the flagship SBELL wins -----------
    # block fill estimated from COORDINATES (unique touched 8x8 blocks),
    # NOT via A.tobsr((8,8)) — on a large scattered matrix tobsr
    # densifies up to 64x host-side before the heuristic can reject it
    n_blocks = np.unique((coo.row.astype(np.int64) >> 3) * (-(-n // 8))
                         + (coo.col.astype(np.int64) >> 3)).size
    if A.nnz >= 0.5 * 64 * max(n_blocks, 1):
        from libhpc_tpu.ops.spmv_pallas import sbell_spmv
        from libhpc_tpu.sparse.sbell import SBELL

        sb = SBELL.from_scipy(A)
        if prefer_bf16:
            import jax.numpy as jnp

            sb = sb.astype_values(jnp.bfloat16)
        return sb, sbell_spmv

    # --- scalar-regular? ELL while its padded rectangle stays tight -----
    from libhpc_tpu.sparse.csr import CSR

    csr = CSR.from_scipy(A)
    lens = np.diff(A.indptr)
    k_pad = -(-int(lens.max()) // 8) * 8 if lens.size else 0
    if A.nnz and k_pad * m <= 4 * A.nnz:
        from libhpc_tpu.ops.spmv import ell_spmv
        from libhpc_tpu.sparse.ell import ELL

        return ELL.from_csr(csr, pad_multiple=8), ell_spmv
    from libhpc_tpu.ops.spmv import csr_spmv

    return csr, csr_spmv
