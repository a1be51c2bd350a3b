"""BELL (block-ELLPACK) — the fast unstructured-SpMV layout.

BSR with each block-row padded to a fixed K blocks, so the SpMV reduction
runs along a *dense* axis (a plain sum) instead of a segment scatter-add.
Padding blocks are zero with column index 0: they
multiply to zero and vanish in the reduction.

The descendant of the reference's dense-leaf tiling
(lib/sparse/include/DenseBlock.hpp:12-13) applied to matrix storage; the
fixed-K discipline is the same static-shape trade the reference makes with
its compile-time BlockSize/GridSize template parameters (SURVEY.md §5.6).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BELL:
    """Block-ELL matrix.

    blocks:  (n_block_rows, K, b, b) dense tiles (zero-padded)
    indices: int32 (n_block_rows, K) block-column ids (0 where padded)
    shape:   element-level (nrows, ncols), multiples of b
    """

    blocks: jax.Array
    indices: jax.Array
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def b(self) -> int:
        return self.blocks.shape[2]

    @property
    def K(self) -> int:
        return self.blocks.shape[1]

    @property
    def n_block_rows(self) -> int:
        return self.blocks.shape[0]

    @property
    def nnz_stored(self) -> int:
        return int(np.prod(self.blocks.shape))

    @property
    def dtype(self):
        return self.blocks.dtype

    @staticmethod
    def from_bsr(bsr) -> "BELL":
        """Host-side conversion from BSR (setup path)."""
        indptr = np.asarray(bsr.indptr)
        indices = np.asarray(bsr.indices)
        blocks = np.asarray(bsr.blocks)
        nbr = len(indptr) - 1
        counts = np.diff(indptr)
        K = max(1, int(counts.max()))
        b = bsr.b
        out_blocks = np.zeros((nbr, K, b, b), blocks.dtype)
        out_idx = np.zeros((nbr, K), np.int32)
        for r in range(nbr):
            c = counts[r]
            out_blocks[r, :c] = blocks[indptr[r]:indptr[r + 1]]
            out_idx[r, :c] = indices[indptr[r]:indptr[r + 1]]
        return BELL(blocks=jnp.asarray(out_blocks),
                    indices=jnp.asarray(out_idx), shape=bsr.shape)

    @staticmethod
    def from_scipy(sp, block: int = 8) -> "BELL":
        from libhpc_tpu.sparse.bsr import BSR

        return BELL.from_bsr(BSR.from_scipy(sp, block=block))

    def fill_ratio(self) -> float:
        true_nnz = int((self.blocks != 0).sum())
        return self.nnz_stored / max(true_nnz, 1)

    @jax.jit
    def todense(self) -> jax.Array:
        nbr, K, b, _ = self.blocks.shape
        nbc = self.shape[1] // b
        out = jnp.zeros((nbr, nbc, b, b), self.blocks.dtype)
        r = jnp.repeat(jnp.arange(nbr), K)
        c = self.indices.reshape(-1)
        out = out.at[r, c].add(self.blocks.reshape(nbr * K, b, b))
        return out.transpose(0, 2, 1, 3).reshape(self.shape)

    def __matmul__(self, x):
        from libhpc_tpu.ops import spmv

        return spmv.bell_spmv(self, jnp.asarray(x))
