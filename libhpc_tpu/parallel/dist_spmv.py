"""Distributed (row-partitioned) SpMV / SpMM / CG over a device mesh.

New work beyond the reference (it is single-node — SURVEY.md §2 'absent'
note): matrices are row-partitioned across the mesh axis; each shard holds

  diag  — the block of columns the shard also owns x for (local compute)
  offd  — every other column, with *global* column indices (needs gathered x)

SpMV overlap discipline (the distributed descendant of the reference's
compute/transfer overlap suite, cuda_tut_transfer_overlap.cu:41-142):
issue the `all_gather` of x first, compute `diag @ x_local` while the
gather is in flight, then the off-diagonal part consumes the gathered
vector — XLA's async collectives give the pattern-A pipeline for free.

Setup is host-side (numpy/scipy, one-time); the hot path is one jitted
shard_map program.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libhpc_tpu.sparse.csr import CSR


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistCSR:
    """Row-partitioned CSR, stacked over shards (leading dim = n_shards).

    diag_*: local-column block CSR (indices are local columns)
    offd_*: remaining columns as CSR with global column indices
    Per-shard nnz is padded to the max across shards with (col 0, val 0).
    """

    diag_data: jax.Array    # (S, nnz_d)
    diag_indices: jax.Array
    diag_indptr: jax.Array  # (S, rows_local + 1)
    offd_data: jax.Array    # (S, nnz_o)
    offd_indices: jax.Array
    offd_indptr: jax.Array
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))

    @property
    def rows_local(self) -> int:
        return self.diag_indptr.shape[1] - 1

    @staticmethod
    def from_scipy(sp, n_shards: int) -> "DistCSR":
        import scipy.sparse as sps

        sp = sp.tocsr()
        nr, nc = sp.shape
        if nr != nc:
            raise ValueError("row partitioning assumes a square matrix")
        rows_local = -(-nr // n_shards)
        n_pad = rows_local * n_shards
        if n_pad != nr:
            pad = n_pad - nr
            sp = sps.bmat(
                [[sp, None], [None, sps.identity(pad, dtype=sp.dtype)]]
            ).tocsr()
        nr = nc = n_pad

        diag, offd = [], []
        for s in range(n_shards):
            r0, r1 = s * rows_local, (s + 1) * rows_local
            c0, c1 = r0, r1
            blk = sp[r0:r1, :].tocsc()
            d = blk[:, c0:c1].tocsr()
            o = sps.hstack(
                [blk[:, :c0], sps.csr_matrix((rows_local, c1 - c0)),
                 blk[:, c1:]]
            ).tocsr()
            d.sort_indices(); o.sort_indices()
            diag.append(d)
            offd.append(o)

        def stack(mats, ncols):
            nnz_max = max(1, max(m.nnz for m in mats))
            data = np.zeros((n_shards, nnz_max), mats[0].dtype)
            idx = np.zeros((n_shards, nnz_max), np.int32)
            ptr = np.zeros((n_shards, rows_local + 1), np.int32)
            for s, m in enumerate(mats):
                data[s, : m.nnz] = m.data
                idx[s, : m.nnz] = m.indices
                ptr[s] = m.indptr
                ptr[s, -1] = m.indptr[-1]  # padded tail nnz stay unreferenced
            return jnp.asarray(data), jnp.asarray(idx), jnp.asarray(ptr)

        dd, di, dp = stack(diag, rows_local)
        od, oi, op = stack(offd, nc)
        return DistCSR(
            diag_data=dd, diag_indices=di, diag_indptr=dp,
            offd_data=od, offd_indices=oi, offd_indptr=op,
            shape=(nr, nc), n_shards=n_shards,
        )

    def shard(self, mesh: Mesh, axis: str = "x") -> "DistCSR":
        """Place the stacked arrays on the mesh (leading dim over `axis`)."""
        sh = NamedSharding(mesh, P(axis))
        put = lambda a: jax.device_put(a, sh)
        return dataclasses.replace(
            self,
            diag_data=put(self.diag_data), diag_indices=put(self.diag_indices),
            diag_indptr=put(self.diag_indptr), offd_data=put(self.offd_data),
            offd_indices=put(self.offd_indices), offd_indptr=put(self.offd_indptr),
        )


def _local_csr_spmv(data, indices, indptr, x, nrows):
    rows = (
        jnp.searchsorted(indptr, jnp.arange(data.shape[0], dtype=jnp.int32),
                         side="right").astype(jnp.int32) - 1
    )
    return jax.ops.segment_sum(data * x[indices], rows, num_segments=nrows)


def dist_spmv_apply(A: DistCSR, x, mesh: Mesh, axis: str = "x"):
    """Traceable distributed matvec (x sharded P(axis)) -> y sharded.

    Inside the shard body: all_gather(x) is issued first; the diagonal-block
    SpMV (pure local) runs while the gather is in flight; the off-diagonal
    SpMV then consumes the gathered vector. A is an argument, so a jitted
    caller passes the matrix as an operand instead of embedding it as a
    compile-time constant.
    """
    rows_local = A.rows_local

    def body(dd, di, dp, od, oi, op, x):
        x_l = x.reshape(-1)                       # local shard (rows_local,)
        xg = lax.all_gather(x_l, axis, tiled=True)  # async collective
        y = _local_csr_spmv(dd[0], di[0], dp[0], x_l, rows_local)
        y = y + _local_csr_spmv(od[0], oi[0], op[0], xg, rows_local)
        return y

    smapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis), P(axis), P(axis),
                  P(axis)),
        out_specs=P(axis),
    )
    return smapped(A.diag_data, A.diag_indices, A.diag_indptr,
                   A.offd_data, A.offd_indices, A.offd_indptr, x)


def dist_spmv_fn(A: DistCSR, mesh: Mesh, axis: str = "x"):
    """The jitted distributed matvec x -> A @ x (see dist_spmv_apply)."""
    return partial(jax.jit(partial(dist_spmv_apply, mesh=mesh, axis=axis)),
                   A)


def dist_cg(A: DistCSR, b, mesh: Mesh, axis: str = "x", tol: float = 1e-6,
            max_iter: int = 1000):
    """Distributed CG: the matvec is the overlapped dist SpMV; the dot
    products reduce over the mesh axis implicitly (x/y are sharded arrays and
    jnp.vdot under jit inserts the psum). One jitted program with A as an
    operand."""
    from libhpc_tpu.ops.solver import cg

    @jax.jit
    def run(A, b):
        return cg(partial(dist_spmv_apply, A, mesh=mesh, axis=axis), b,
                  tol=tol, max_iter=max_iter)

    return run(A, b)


def dist_spmm_fn(A: DistCSR, mesh: Mesh, n_cols: int, axis: str = "x"):
    """Distributed SpMM: rows of A partitioned, B (n, c) row-sharded like x;
    result Y (m, c) row-sharded. Same diag/offd overlap as dist_spmv."""
    rows_local = A.rows_local

    def _local_spmm(data, indices, indptr, B, nrows):
        rows = (
            jnp.searchsorted(indptr,
                             jnp.arange(data.shape[0], dtype=jnp.int32),
                             side="right").astype(jnp.int32) - 1
        )
        prod = data[:, None] * B[indices]
        return jax.ops.segment_sum(prod, rows, num_segments=nrows)

    def body(dd, di, dp, od, oi, op, B):
        Bg = lax.all_gather(B, axis, tiled=True)
        Y = _local_spmm(dd[0], di[0], dp[0], B, rows_local)
        Y = Y + _local_spmm(od[0], oi[0], op[0], Bg, rows_local)
        return Y

    smapped = jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(axis),) * 7,
        out_specs=P(axis),
    )

    @jax.jit
    def matmat(B):
        return smapped(A.diag_data, A.diag_indices, A.diag_indptr,
                       A.offd_data, A.offd_indices, A.offd_indptr, B)

    return matmat
