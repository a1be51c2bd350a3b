"""2D block-partitioned distributed SpMV (SUMMA-style).

Scales past 1D row partitioning when the per-chip x shard no longer fits or
the all-gather dominates: the matrix is split into a (Pr × Pc) block grid
over a 2D mesh ('py' × 'px'); x is sharded along 'px' and replicated along
'py'. One SpMV:

    partial_i = A_{i,j} @ x_j            (local, each device)
    y_i       = psum(partial_i, 'px')    (row-wise reduction across px)

y comes back sharded over 'py' and replicated over 'px' — the transpose
distribution of x, re-aligned for iterative use with one collective
permute (`realign=True`).

Communication per SpMV: one psum of rows_local elements along 'px'
(vs all-gather of n elements in 1D) — the standard 2D scaling trade.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Dist2DCSR:
    """CSR blocks stacked over a (Pr, Pc) grid; per-block nnz padded to the
    global max. Leading two dims shard over mesh axes ('py', 'px')."""

    data: jax.Array     # (Pr, Pc, nnz_max)
    indices: jax.Array  # (Pr, Pc, nnz_max) — local column indices
    indptr: jax.Array   # (Pr, Pc, rows_local + 1)
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    grid: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def rows_local(self) -> int:
        return self.indptr.shape[2] - 1

    @property
    def cols_local(self) -> int:
        return self.shape[1] // self.grid[1]

    @staticmethod
    def from_scipy(sp, grid: tuple) -> "Dist2DCSR":
        import scipy.sparse as sps

        pr, pc = grid
        sp = sp.tocsr()
        nr, nc = sp.shape
        rows_local = -(-nr // pr)
        cols_local = -(-nc // pc)
        nrp, ncp = rows_local * pr, cols_local * pc
        if (nrp, ncp) != (nr, nc):
            sp = sps.csr_matrix(
                sps.vstack([
                    sps.hstack([sp, sps.csr_matrix((nr, ncp - nc),
                                                   dtype=sp.dtype)]),
                    sps.csr_matrix((nrp - nr, ncp), dtype=sp.dtype),
                ])
            )
        blocks = [[sp[i * rows_local:(i + 1) * rows_local,
                      j * cols_local:(j + 1) * cols_local].tocsr()
                   for j in range(pc)] for i in range(pr)]
        nnz_max = max(1, max(b.nnz for row in blocks for b in row))
        data = np.zeros((pr, pc, nnz_max), sp.dtype)
        idx = np.zeros((pr, pc, nnz_max), np.int32)
        ptr = np.zeros((pr, pc, rows_local + 1), np.int32)
        for i in range(pr):
            for j in range(pc):
                b = blocks[i][j]
                b.sort_indices()
                data[i, j, : b.nnz] = b.data
                idx[i, j, : b.nnz] = b.indices
                ptr[i, j] = b.indptr
        return Dist2DCSR(
            data=jnp.asarray(data), indices=jnp.asarray(idx),
            indptr=jnp.asarray(ptr), shape=(nrp, ncp), grid=grid,
        )

    def shard(self, mesh: Mesh, axes=("py", "px")) -> "Dist2DCSR":
        sh = NamedSharding(mesh, P(*axes))
        put = lambda a: jax.device_put(a, sh)
        return dataclasses.replace(
            self, data=put(self.data), indices=put(self.indices),
            indptr=put(self.indptr),
        )


def dist2d_spmv_fn(A: Dist2DCSR, mesh: Mesh, axes=("py", "px"),
                   realign: bool = True):
    """Jitted 2D SpMV (A is passed to the jitted program as an operand).

    Input x: sharded P(axes[1]) (i.e. over 'px', replicated over 'py'),
    given as a 1D global vector. Output y:
      realign=True  → same distribution as x (usable in solvers)
      realign=False → sharded over 'py' (one fewer redistribution)

    Requires square block grids (Pr == Pc) for realign, and
    rows_local == cols_local.
    """
    ay, ax = axes
    pr, pc = A.grid
    rows_local = A.rows_local
    if realign and rows_local != A.cols_local:
        raise ValueError(
            "realign=True needs a square block grid (rows_local == "
            f"cols_local), got {rows_local} vs {A.cols_local}"
        )

    def body(dd, di, dp, x):
        # dd: (1, 1, nnz) local block; x: (cols_local,) local shard
        x_l = x.reshape(-1)
        data, idx, ptr = dd[0, 0], di[0, 0], dp[0, 0]
        rows = (
            jnp.searchsorted(ptr, jnp.arange(data.shape[0], dtype=jnp.int32),
                             side="right").astype(jnp.int32) - 1
        )
        part = jax.ops.segment_sum(data * x_l[idx], rows,
                                   num_segments=rows_local)
        y = lax.psum(part, ax)          # row-wise reduce over the px axis
        if realign:
            # y is sharded over py, replicated over px; transpose the
            # distribution so y matches x's layout: device (i, j) needs the
            # y block owned by row j. With Pr == Pc this is a mesh-diagonal
            # exchange: all_gather over py then select the px-th block.
            yg = lax.all_gather(y, ay, tiled=True)    # full y, per column
            jidx = lax.axis_index(ax)
            y = lax.dynamic_slice_in_dim(yg, jidx * rows_local, rows_local)
        return y

    smapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(ay, ax), P(ay, ax), P(ay, ax), P(ax)),
        out_specs=P(ax) if realign else P(ay),
        # replication across the non-output axis comes from psum/slice
        # chains the static checker can't see through
        check_vma=False,
    )

    @jax.jit
    def apply(A, x):
        return smapped(A.data, A.indices, A.indptr, x)

    return partial(apply, A)
