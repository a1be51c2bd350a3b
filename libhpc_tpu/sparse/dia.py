"""DIA (diagonal) sparse format — the zero-gather fast path.

For banded matrices (Poisson stencils, structured FEM) SpMV becomes a
static set of shifted elementwise multiply-adds: no index arrays, no
gather — pure streaming that XLA fuses into one elementwise pass. This
is the format-level expression of the reference's stencil insight (the blur
kernels read a(y, x±r) at static offsets, test_hpc_benchmark.cpp:354-601):
when the sparsity pattern is structured, encode it in the *program*, not in
index data.

Storage follows scipy.sparse.dia_matrix: data[d, j] holds A[j - offset[d], j]
(column-aligned diagonals). Offsets are static (compile-time constants).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DIA:
    """data: (ndiags, ncols); offsets/shape static."""

    data: jax.Array
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def ndiags(self) -> int:
        return len(self.offsets)

    @property
    def nnz_stored(self) -> int:
        return self.data.shape[0] * self.data.shape[1]

    @property
    def dtype(self):
        return self.data.dtype

    @staticmethod
    def from_scipy(sp) -> "DIA":
        d = sp.todia()
        data = np.asarray(d.data)
        ncols = d.shape[1]
        if data.shape[1] < ncols:  # scipy may emit a narrower data array
            data = np.pad(data, ((0, 0), (0, ncols - data.shape[1])))
        return DIA(
            data=jnp.asarray(data),
            offsets=tuple(int(o) for o in d.offsets),
            shape=d.shape,
        )

    @staticmethod
    def from_csr(csr) -> "DIA":
        return DIA.from_scipy(csr.to_scipy())

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.dia_matrix(
            (np.asarray(self.data), np.asarray(self.offsets, np.int64)),
            shape=self.shape,
        ).tocsr()

    @jax.jit
    def todense(self) -> jax.Array:
        m, n = self.shape
        out = jnp.zeros((m, n), self.data.dtype)
        cols = jnp.arange(n)
        for d, o in enumerate(self.offsets):
            rows = cols - o
            valid = (rows >= 0) & (rows < m)
            out = out.at[jnp.where(valid, rows, 0),
                         jnp.where(valid, cols, 0)].add(
                jnp.where(valid, self.data[d], 0)
            )
        return out

    def __matmul__(self, x):
        from libhpc_tpu.ops.spmv import dia_spmv

        return dia_spmv(self, jnp.asarray(x))
