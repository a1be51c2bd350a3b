"""CSR sparse matrix as a JAX pytree.

The workhorse container (BASELINE.json configs[0]): static-shape CSR with
int32 indices, scipy bridges for oracle testing, and conversions to the
ELL/BSR compute layouts.

Design note (SURVEY.md §7 "hard parts" #1): scalar gathers are the
expensive part of SpMV, so CSR itself is the *interchange* format; the
compute formats are ELL (bounded nnz/row, dense gather) and BSR/SBELL
(8×8 block dots).
CSR SpMV falls back to gather + segment-sum, which XLA compiles well enough
to be HBM-bound for moderate row irregularity.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed sparse row matrix.

    indptr: int32 (nrows+1,), indices: int32 (nnz,), data: (nnz,).
    Explicit zero padding entries (col 0, value 0) are permitted — all ops
    are additive so padding is harmless.
    """

    data: jax.Array
    indices: jax.Array
    indptr: jax.Array
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_scipy(sp) -> "CSR":
        sp = sp.tocsr()
        sp.sort_indices()
        return CSR(
            data=jnp.asarray(sp.data),
            indices=jnp.asarray(sp.indices, jnp.int32),
            indptr=jnp.asarray(sp.indptr, jnp.int32),
            shape=sp.shape,
        )

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.csr_matrix(
            (np.asarray(self.data), np.asarray(self.indices), np.asarray(self.indptr)),
            shape=self.shape,
        )

    @staticmethod
    def from_dense(mat) -> "CSR":
        import scipy.sparse as sps

        return CSR.from_scipy(sps.csr_matrix(np.asarray(mat)))

    @staticmethod
    @jax.jit
    def from_coo(coo) -> "CSR":
        """Row-sort the COO triplets and build indptr via searchsorted.

        This is the batch construction path replacing the reference's
        insert-on-touch grid build (HashBlock.hpp:92-102): sort by (row, col),
        then one vectorized searchsorted instead of per-element hash inserts.
        """
        c = coo.sort_indices("row")
        nrows = coo.shape[0]
        indptr = jnp.searchsorted(
            c.row, jnp.arange(nrows + 1, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
        return CSR(data=c.data, indices=c.col, indptr=indptr, shape=coo.shape)

    def tocoo(self):
        from libhpc_tpu.sparse.coo import COO

        return COO(
            row=self.row_of_nnz(), col=self.indices, data=self.data, shape=self.shape
        )

    # -- derived index structures -----------------------------------------

    @jax.jit
    def row_of_nnz(self) -> jax.Array:
        """int32 (nnz,): the row index of every stored element.

        Vectorized expansion of indptr (the 'segment ids' view): for each
        nnz position p, the row r with indptr[r] <= p < indptr[r+1].
        """
        return (
            jnp.searchsorted(
                self.indptr,
                jnp.arange(self.nnz, dtype=jnp.int32),
                side="right",
            ).astype(jnp.int32)
            - 1
        )

    @jax.jit
    def row_lengths(self) -> jax.Array:
        return self.indptr[1:] - self.indptr[:-1]

    def max_row_length(self) -> int:
        """Host-side max nnz/row (concrete int; pulls one scalar)."""
        return int(jnp.max(self.row_lengths()))

    @jax.jit
    def todense(self) -> jax.Array:
        out = jnp.zeros(self.shape, self.data.dtype)
        return out.at[self.row_of_nnz(), self.indices].add(self.data)

    # -- format conversions ------------------------------------------------

    def to_ell(self, max_nnz_per_row: int | None = None, pad_multiple: int = 8):
        from libhpc_tpu.sparse.ell import ELL

        return ELL.from_csr(self, max_nnz_per_row, pad_multiple=pad_multiple)

    def to_bsr(self, block: int = 8):
        from libhpc_tpu.sparse.bsr import BSR

        return BSR.from_csr(self, block=block)

    # -- ops (thin wrappers over libhpc_tpu.ops) ---------------------------

    def __matmul__(self, x):
        from libhpc_tpu.ops import spmv, spmm

        x = jnp.asarray(x)
        if x.ndim == 1:
            return spmv.csr_spmv(self, x)
        return spmm.csr_spmm(self, x)
