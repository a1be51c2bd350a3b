"""Sparse matrix–vector products (the BASELINE.json north-star op).

Three compute paths, chosen by storage format:

  csr_spmv(csr, x)  — gather + segment-sum. The interchange-format fallback:
                      XLA compiles the gather + the segmented reduction into
                      an HBM-streaming loop. Bytes/nnz ≈ 8 (data+index) plus
                      x traffic.
  ell_spmv(ell, x)  — dense-rectangle path: x[cols] is a dense gather of a
                      (nrows, k) index plane, the reduce a dense axis-sum.
                      Best when row lengths are regular (Poisson, stencils).
  bsr_spmv(bsr, x)  — block path: batched b×b block-dots + block-row segment
                      sum (BASELINE.json configs[1], 8×8 SuiteSparse blocks).

The reference has no SpMV (it is a primitives library); these ops are the
designated re-expression of its sparse-grid + SIMD-stencil capabilities
per BASELINE.json. Reduction structure descends from the reference's
count→scan→scatter skeleton (SURVEY.md §3.2) with the scatter expressed as
a segment-sum.

Every float32 contraction names precision HIGHEST, so a GPU never runs it
in TF32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def csr_spmv(csr, x):
    """y = A @ x for CSR A. Padding entries (col 0, val 0) contribute 0."""
    prod = csr.data * x[csr.indices]
    return jax.ops.segment_sum(
        prod, csr.row_of_nnz(), num_segments=csr.shape[0]
    )


@jax.jit
def ell_spmv(ell, x):
    """y = A @ x for ELL A — the regular-row fast path."""
    return jnp.sum(ell.vals * x[ell.cols], axis=1)


@jax.jit
def bsr_spmv(bsr, x):
    """y = A @ x for BSR A via batched block-dots."""
    b = bsr.b
    xb = x.reshape(-1, b)                       # (n_block_cols, b)
    gx = xb[bsr.indices]                        # (nblocks, b)
    prod = jnp.einsum(
        "nij,nj->ni", bsr.blocks, gx,
        preferred_element_type=bsr.blocks.dtype,
        precision=jax.lax.Precision.HIGHEST,
    )
    yb = jax.ops.segment_sum(
        prod, bsr.block_row_of_block(), num_segments=bsr.n_block_rows,
        indices_are_sorted=True,
    )
    return yb.reshape(-1)


@jax.jit
def bell_spmv(bell, x):
    """y = A @ x for BELL A — the unstructured fast path.

    One row-gather of x per block and a dense-axis reduction; no
    scatter/segment_sum anywhere (padding blocks multiply to zero)."""
    b = bell.b
    xb = x.reshape(-1, b)                         # (n_block_cols, b)
    g = xb[bell.indices]                          # (nbr, K, b) row-gather
    # contraction over (K, j): blocks (nbr,K,b,b) . g (nbr,K,b) -> (nbr,b)
    yb = jnp.einsum("rkij,rkj->ri", bell.blocks, g,
                    preferred_element_type=bell.blocks.dtype,
                    precision=jax.lax.Precision.HIGHEST)
    return yb.reshape(-1)


@jax.jit
def coo_spmv(coo, x):
    prod = coo.data * x[coo.col]
    return jax.ops.segment_sum(prod, coo.row, num_segments=coo.shape[0])


# dia_spmv unrolls one HLO slice+add pair per diagonal; past this many
# offsets the program blows up (O(n_diag) ops, unbounded compile time on a
# quasi-structured matrix) — callers should convert to BandedHybrid or
# SBELL instead.
MAX_DIA_OFFSETS = 96


def _guard_dia(dia):
    if len(dia.offsets) > MAX_DIA_OFFSETS:
        raise ValueError(
            f"dia_spmv: {len(dia.offsets)} diagonal offsets exceeds the "
            f"compile-safety cap of {MAX_DIA_OFFSETS}; this matrix is only "
            "quasi-structured — use hybrid_spmv (RCM band + ELL rest) or "
            "the SBELL path (ops/spmv_pallas.py) instead.")


@jax.jit
def dia_spmv(dia, x):
    """y = A @ x for DIA A — zero-gather shifted multiply-adds.

    Each static diagonal offset o contributes
      y[j - o] += data[d, j] * x[j]   for valid columns j
    expressed as PAD + ADD of the sliced products (not `.at[].add`):
    dynamic-update-slice chains make XLA re-read and re-write the full y
    per diagonal; pad+add fuses into one elementwise pass.
    """
    _guard_dia(dia)
    m, n = dia.shape
    y = jnp.zeros((m,), dia.data.dtype)
    for d, o in enumerate(dia.offsets):
        # valid columns j: max(0, o) <= j < min(n, m + o)
        j0 = max(0, o)
        j1 = min(n, m + o)
        if j1 <= j0:
            continue
        contrib = dia.data[d, j0:j1] * x[j0:j1]
        y = y + jnp.pad(contrib, (j0 - o, m - (j1 - o)))
    return y


@jax.jit
def csr_spmv_t(csr, y):
    """x = A^T @ y for CSR A (the CSC view): products scatter over columns,
    expressed as a segment-sum over the column ids (sorted per row, not
    globally — XLA handles unsorted segment ids)."""
    prod = csr.data * y[csr.row_of_nnz()]
    return jax.ops.segment_sum(prod, csr.indices, num_segments=csr.shape[1])


@jax.jit
def dia_spmv_t(dia, y):
    """x = A^T @ y for DIA A: the transpose of a diagonal matrix is the
    diagonal set negated — same zero-gather streaming structure (pad+add
    form for single-pass fusion, see dia_spmv)."""
    _guard_dia(dia)
    m, n = dia.shape
    x = jnp.zeros((n,), dia.data.dtype)
    for d, o in enumerate(dia.offsets):
        j0 = max(0, o)
        j1 = min(n, m + o)
        if j1 <= j0:
            continue
        x = x + jnp.pad(dia.data[d, j0:j1] * y[j0 - o : j1 - o],
                        (j0, n - j1))
    return x


@jax.jit
def hybrid_spmv(hyb, x):
    """y = A @ x for BandedHybrid A: permute → DIA band (streaming) + ELL
    remainder (gather-bound, small by construction) → unpermute."""
    xp = x[hyb.perm]
    yp = dia_spmv(hyb.band, xp) + ell_spmv(hyb.rest, xp)
    return yp[hyb.iperm]
