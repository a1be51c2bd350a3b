"""ELL (ELLPACK) sparse format — the dense compute layout for row-wise SpMV.

Each row stores exactly ``k = max_nnz_per_row`` (column, value) slots, padded
with (0, 0.0). This converts CSR row irregularity into a dense (nrows, k)
rectangle: gathers become dense ``x[cols]`` takes and the reduction a dense
axis sum — both of which XLA fuses into one pass. This is the mitigation
for SURVEY.md §7 hard-part #1 (irregular scalar gathers).

Padding-invariance is a first-class correctness property here, mirroring the
reference's ``IgnoresPadding`` GPU test variants
(tests/test_radixsort_gpu_local_count/src/test_radix_local_count.cu:15-197).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ELL:
    """cols: int32 (nrows, k); vals: (nrows, k); padded slots are (0, 0)."""

    vals: jax.Array
    cols: jax.Array
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def k(self) -> int:
        return self.cols.shape[1]

    @property
    def dtype(self):
        return self.vals.dtype

    @staticmethod
    def from_csr(csr, max_nnz_per_row: int | None = None, pad_multiple: int = 8) -> "ELL":
        """Pack CSR into ELL.

        Setup transform — runs host-side in numpy (one-time cost; keeps the
        accelerator out of the conversion path entirely). k is rounded up to
        ``pad_multiple``.
        """
        indptr = np.asarray(csr.indptr)
        indices = np.asarray(csr.indices)
        data = np.asarray(csr.data)
        lengths = np.diff(indptr)
        actual_max = int(lengths.max()) if lengths.size else 0
        if max_nnz_per_row is None:
            max_nnz_per_row = actual_max
        elif max_nnz_per_row < actual_max:
            raise ValueError(
                f"max_nnz_per_row={max_nnz_per_row} < actual max row length "
                f"{actual_max}; entries would be dropped"
            )
        k = max(1, -(-max_nnz_per_row // pad_multiple) * pad_multiple)
        nrows = csr.shape[0]
        if len(indices) == 0:  # empty matrix: all-padding ELL
            return ELL(
                vals=jnp.zeros((nrows, k), data.dtype),
                cols=jnp.zeros((nrows, k), jnp.int32),
                shape=csr.shape,
            )
        slot = np.arange(k, dtype=np.int64)[None, :]
        src = indptr[:-1, None].astype(np.int64) + slot
        valid = slot < lengths[:, None]
        src = np.where(valid, src, 0)
        cols = np.where(valid, indices[src], 0).astype(np.int32)
        vals = np.where(valid, data[src], 0).astype(data.dtype)
        return ELL(vals=jnp.asarray(vals), cols=jnp.asarray(cols),
                   shape=csr.shape)

    @staticmethod
    def from_scipy(sp, pad_multiple: int = 8) -> "ELL":
        from libhpc_tpu.sparse.csr import CSR

        return ELL.from_csr(CSR.from_scipy(sp), pad_multiple=pad_multiple)

    @jax.jit
    def todense(self) -> jax.Array:
        out = jnp.zeros(self.shape, self.vals.dtype)
        rows = jnp.broadcast_to(
            jnp.arange(self.shape[0], dtype=jnp.int32)[:, None], self.cols.shape
        )
        return out.at[rows, self.cols].add(self.vals)

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.csr_matrix(np.asarray(self.todense()))


