"""COO (coordinate) sparse matrix as a JAX pytree.

Entry point of the container stack: construction from raw triplets, sorting
into canonical (row-major, Morton, or column-major) order via the radix-style
key sort, and conversion to CSR. This replaces the reference's insert-on-touch
hierarchical grid construction path (lib/sparse/include/HashBlock.hpp:92-102)
with a batch-oriented sort-then-segment flow, the idiomatic JAX form.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from libhpc_tpu.utils.morton import morton2d_encode


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix.

    ``row``/``col`` are int32 arrays of shape (nnz,), ``data`` any dtype of
    shape (nnz,). ``shape`` is static. Duplicate coordinates are allowed until
    :meth:`sum_duplicates` is called.
    """

    row: jax.Array
    col: jax.Array
    data: jax.Array
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    # -- construction ------------------------------------------------------

    @staticmethod
    def from_dense(mat) -> "COO":
        mat = np.asarray(mat)
        r, c = np.nonzero(mat)
        return COO(
            row=jnp.asarray(r, jnp.int32),
            col=jnp.asarray(c, jnp.int32),
            data=jnp.asarray(mat[r, c]),
            shape=mat.shape,
        )

    @staticmethod
    def from_scipy(sp) -> "COO":
        sp = sp.tocoo()
        return COO(
            row=jnp.asarray(sp.row, jnp.int32),
            col=jnp.asarray(sp.col, jnp.int32),
            data=jnp.asarray(sp.data),
            shape=sp.shape,
        )

    def to_scipy(self):
        import scipy.sparse as sps

        return sps.coo_matrix(
            (np.asarray(self.data), (np.asarray(self.row), np.asarray(self.col))),
            shape=self.shape,
        )

    # -- ops ---------------------------------------------------------------

    @jax.jit
    def todense(self) -> jax.Array:
        out = jnp.zeros(self.shape, self.data.dtype)
        return out.at[self.row, self.col].add(self.data)

    @partial(jax.jit, static_argnames=("order",))
    def sort_indices(self, order: str = "row") -> "COO":
        """Sort triplets into canonical order.

        order: 'row' (row-major CSR order), 'col', or 'morton' (Z-order, the
        locality layout replacing libmorton tiling in the reference).
        """
        if order == "row":
            _, _, r, c, d = jax.lax.sort(
                (self.row, self.col, self.row, self.col, self.data), num_keys=2
            )
        elif order == "col":
            _, _, r, c, d = jax.lax.sort(
                (self.col, self.row, self.row, self.col, self.data), num_keys=2
            )
        elif order == "morton":
            key = morton2d_encode(
                self.col.astype(jnp.uint32), self.row.astype(jnp.uint32)
            )
            _, r, c, d = jax.lax.sort(
                (key, self.row, self.col, self.data), num_keys=1
            )
        else:
            raise ValueError(f"unknown order {order!r}")
        return COO(row=r, col=c, data=d, shape=self.shape)

    @jax.jit
    def sum_duplicates(self) -> "COO":
        """Combine duplicate coordinates (sorted row-major output).

        Static-shape discipline: output keeps nnz slots; duplicates collapse
        into the first occurrence and freed slots become explicit zeros at
        (last_row, last_col)-adjacent positions with zero data, which every
        downstream op treats as no-ops.
        """
        c = self.sort_indices("row")
        is_head = jnp.concatenate(
            [
                jnp.ones((1,), bool),
                (c.row[1:] != c.row[:-1]) | (c.col[1:] != c.col[:-1]),
            ]
        )
        seg = jnp.cumsum(is_head) - 1
        n = self.nnz
        data = jax.ops.segment_sum(c.data, seg, num_segments=n)
        row = jax.ops.segment_max(c.row, seg, num_segments=n)
        col = jax.ops.segment_max(c.col, seg, num_segments=n)
        nseg = seg[-1] + 1
        idx = jnp.arange(n)
        valid = idx < nseg
        # pad tail with zero-data entries at (0, 0) — harmless for add-based ops
        return COO(
            row=jnp.where(valid, row, 0).astype(jnp.int32),
            col=jnp.where(valid, col, 0).astype(jnp.int32),
            data=jnp.where(valid, data, 0),
            shape=self.shape,
        )

    def tocsr(self):
        from libhpc_tpu.sparse.csr import CSR

        return CSR.from_coo(self)
