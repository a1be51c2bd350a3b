"""Sparse × dense (tall-skinny) matrix products — SpMM.

BASELINE.json configs[2]: sparse × dense with ~64 columns. The dense
right-hand side amortizes index traffic: each gathered row of B is a
(k, ncols) dense tile and the segmented reduction amortizes index traffic
over ncols columns.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def csr_spmm(csr, B):
    """Y = A @ B, A CSR (m×n), B dense (n, c)."""
    gB = B[csr.indices]                      # (nnz, c)
    prod = csr.data[:, None] * gB
    return jax.ops.segment_sum(
        prod, csr.row_of_nnz(), num_segments=csr.shape[0]
    )


@jax.jit
def ell_spmm(ell, B):
    """Y = A @ B, A ELL (m×n) with k slots/row, B dense (n, c).

    Gathers B into a (m, k, c) brick and contracts k — a dense einsum.
    """
    gB = B[ell.cols]                         # (m, k, c)
    # precision="highest": a float32 contraction must not run as TF32 /
    # bf16 passes (~1e-2 rel error on standard-normal data). These ops
    # are gather/bandwidth bound, so full f32 costs nothing.
    return jnp.einsum(
        "mk,mkc->mc", ell.vals, gB, preferred_element_type=ell.vals.dtype,
        precision="highest",
    )


@jax.jit
def bsr_spmm(bsr, B):
    """Y = A @ B, A BSR (m×n) with b×b blocks, B dense (n, c).

    (nblocks, b, b) × (nblocks, b, c) batched matmul + block-row
    segment sum.
    """
    b = bsr.b
    c = B.shape[1]
    Bb = B.reshape(-1, b, c)                 # (n_block_cols, b, c)
    gB = Bb[bsr.indices]                     # (nblocks, b, c)
    prod = jnp.einsum(
        "nij,njc->nic", bsr.blocks, gB,
        preferred_element_type=bsr.blocks.dtype,
        precision="highest",
    )
    Yb = jax.ops.segment_sum(
        prod, bsr.block_row_of_block(), num_segments=bsr.n_block_rows
    )
    return Yb.reshape(bsr.shape[0], c)
