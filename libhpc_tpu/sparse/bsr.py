"""BSR (block sparse row) — the dense-block compute layout.

Dense ``b×b`` tiles addressed by a block-level CSR structure, with blocks
optionally laid out in Morton order for locality (the descendant
of the reference's hierarchical DenseBlock leaves,
lib/sparse/include/DenseBlock.hpp:12-13, and its libmorton tilings).

Block values are stored as one (nblocks, b, b) array so the block SpMV /
SpMM stream whole blocks and contract them as batched ``b×b`` dots
(BASELINE.json configs[1]: 8×8 blocks on SuiteSparse matrices).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-CSR matrix.

    blocks:  (nblocks, b, b) dense tiles
    indices: int32 (nblocks,) block-column index of each tile
    indptr:  int32 (n_block_rows + 1,)
    shape:   element-level (nrows, ncols); must be multiples of b
    """

    blocks: jax.Array
    indices: jax.Array
    indptr: jax.Array
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def b(self) -> int:
        return self.blocks.shape[1]

    @property
    def n_block_rows(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def nblocks(self) -> int:
        return self.blocks.shape[0]

    @property
    def nnz_stored(self) -> int:
        """Stored element count including intra-block zero fill-in."""
        return self.nblocks * self.b * self.b

    @property
    def dtype(self):
        return self.blocks.dtype

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_scipy(sp, block: int = 8, morton: bool = False) -> "BSR":
        """Host-side conversion via scipy's BSR (setup path, not jitted)."""
        import scipy.sparse as sps

        nr, nc = sp.shape
        b = block
        nr_pad = -(-nr // b) * b
        nc_pad = -(-nc // b) * b
        if (nr_pad, nc_pad) != (nr, nc):
            sp = sps.csr_matrix(
                (sp.tocsr().data, sp.tocsr().indices, sp.tocsr().indptr),
                shape=(nr, nc),
            )
            sp = sps.vstack(
                [sp, sps.csr_matrix((nr_pad - nr, nc), dtype=sp.dtype)]
            )
            sp = sps.hstack(
                [sp, sps.csr_matrix((nr_pad, nc_pad - nc), dtype=sp.dtype)]
            ).tocsr()
        bsr = sp.tobsr(blocksize=(b, b))
        bsr.sort_indices()
        blocks = jnp.asarray(bsr.data)
        indices = jnp.asarray(bsr.indices, jnp.int32)
        indptr = jnp.asarray(bsr.indptr, jnp.int32)
        if morton:
            blocks, indices, indptr = _morton_reorder(blocks, indices, indptr)
        return BSR(blocks=blocks, indices=indices, indptr=indptr,
                   shape=(nr_pad, nc_pad))

    @staticmethod
    def from_csr(csr, block: int = 8, morton: bool = False) -> "BSR":
        return BSR.from_scipy(csr.to_scipy(), block=block, morton=morton)

    @staticmethod
    def from_dense(mat, block: int = 8) -> "BSR":
        import scipy.sparse as sps

        return BSR.from_scipy(sps.csr_matrix(np.asarray(mat)), block=block)

    # -- derived -----------------------------------------------------------

    @jax.jit
    def block_row_of_block(self) -> jax.Array:
        return (
            jnp.searchsorted(
                self.indptr,
                jnp.arange(self.nblocks, dtype=jnp.int32),
                side="right",
            ).astype(jnp.int32)
            - 1
        )

    @jax.jit
    def todense(self) -> jax.Array:
        b = self.b
        nbr = self.n_block_rows
        nbc = self.shape[1] // b
        out = jnp.zeros((nbr, nbc, b, b), self.blocks.dtype)
        out = out.at[self.block_row_of_block(), self.indices].add(self.blocks)
        return out.transpose(0, 2, 1, 3).reshape(self.shape)

    def to_scipy(self):
        """Host scipy CSR with duplicate blocks summed and zeros dropped,
        built from the blocks — never densified."""
        import scipy.sparse as sps

        A = sps.bsr_matrix((np.asarray(self.blocks),
                            np.asarray(self.indices),
                            np.asarray(self.indptr)),
                           shape=self.shape).tocsr()
        A.sum_duplicates()
        A.eliminate_zeros()
        return A

    def fill_ratio(self) -> float:
        """Stored elements / true nonzeros — the BSR fill-in overhead metric
        (SURVEY.md §7 hard-part #1: 'measured fill-in overhead')."""
        true_nnz = int((self.blocks != 0).sum())
        return self.nnz_stored / max(true_nnz, 1)

    def __matmul__(self, x):
        from libhpc_tpu.ops import spmv

        return spmv.bsr_spmv(self, jnp.asarray(x))


def _morton_reorder(blocks, indices, indptr):
    """Reorder blocks within each block-row by Morton code of (brow, bcol).

    Within a CSR block-row the column order already gives locality; Morton
    ordering matters when we later fuse multiple block-rows per grid step.
    Kept host-side (numpy) — this is a one-time setup transform.
    """
    from libhpc_tpu.utils.morton import morton2d_encode

    blocks_np = np.asarray(blocks)
    indices_np = np.asarray(indices)
    indptr_np = np.asarray(indptr)
    brow = np.repeat(np.arange(len(indptr_np) - 1), np.diff(indptr_np))
    code = np.asarray(
        morton2d_encode(indices_np.astype(np.uint32), brow.astype(np.uint32))
    )
    # stable sort by (brow, morton) keeps CSR structure valid per row
    order = np.lexsort((code, brow))
    return (
        jnp.asarray(blocks_np[order]),
        jnp.asarray(indices_np[order], jnp.int32),
        jnp.asarray(indptr_np, jnp.int32),
    )
