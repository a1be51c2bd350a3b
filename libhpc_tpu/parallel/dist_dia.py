"""Distributed banded SpMV: row-partitioned DIA with halo exchange.

The production distributed path for structured systems (Poisson/stencil
matrices — BASELINE.json configs[0]/[3]/[4] weak scaling): each shard owns
``rows_local`` rows and a DIA slice whose column window extends ``maxoff``
past the shard on both sides. One SpMV is then

    halo = ppermute edges (maxoff elements per neighbor)   [peer traffic]
    y    = dia_spmv(local_band, [left_halo | x_local | right_halo])

— zero gather, zero all_gather: communication is O(maxoff) per neighbor
instead of O(n) per device, and the multiply is the DIA streaming form
(no index traffic at all). This is the halo-exchange SpMV
the BASELINE north-star describes, and the direct distributed descendant of
the reference's ghost-cell stencils (HPCHighDimensionFlatArray halos).

Requires matrix bandwidth ≤ rows_per_shard (each halo comes from the
immediate neighbor). Setup is host-side scipy; the hot path is one
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

from libhpc_tpu.sparse.dia import DIA


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistDIA:
    """data: (n_shards, ndiags, rows_local + 2*maxoff); offsets are the
    *local-window* offsets (global offset + maxoff), identical across
    shards."""

    data: jax.Array
    offsets: tuple = dataclasses.field(metadata=dict(static=True))
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    maxoff: int = dataclasses.field(metadata=dict(static=True))

    @property
    def rows_local(self) -> int:
        return self.shape[0] // self.n_shards

    @staticmethod
    def from_scipy(sp, n_shards: int) -> "DistDIA":
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

        global_offsets = sorted(int(o) for o in sp.todia().offsets)
        maxoff = max(abs(o) for o in global_offsets) if global_offsets else 0
        if maxoff > rows_local:
            raise ValueError(
                f"matrix bandwidth {maxoff} exceeds rows_per_shard "
                f"{rows_local}; halos would span multiple neighbors"
            )
        width = rows_local + 2 * maxoff
        local_offsets = tuple(o + maxoff for o in global_offsets)

        data = np.zeros((n_shards, len(global_offsets), width), sp.dtype)
        for s in range(n_shards):
            r0, r1 = s * rows_local, (s + 1) * rows_local
            c0, c1 = r0 - maxoff, r1 + maxoff
            c0c, c1c = max(0, c0), min(nc, c1)
            W = sp[r0:r1, c0c:c1c]
            blocks = []
            if c0c - c0:
                blocks.append(sps.csr_matrix((rows_local, c0c - c0),
                                             dtype=sp.dtype))
            blocks.append(W)
            if c1 - c1c:
                blocks.append(sps.csr_matrix((rows_local, c1 - c1c),
                                             dtype=sp.dtype))
            Wd = sps.hstack(blocks).todia()
            off_index = {o: i for i, o in enumerate(local_offsets)}
            for d, o in enumerate(Wd.offsets):
                if int(o) not in off_index:
                    if Wd.data[d].any():
                        raise AssertionError(
                            f"unexpected diagonal {o} in shard {s}"
                        )
                    continue
                data[s, off_index[int(o)], : Wd.data.shape[1]] = Wd.data[d]
        return DistDIA(
            data=jnp.asarray(data),
            offsets=local_offsets,
            shape=(nr, nc),
            n_shards=n_shards,
            maxoff=maxoff,
        )

    def shard(self, mesh: Mesh, axis: str = "x") -> "DistDIA":
        sh = NamedSharding(mesh, P(axis))
        return dataclasses.replace(self, data=jax.device_put(self.data, sh))


def dist_dia_spmv_apply(A: DistDIA, x, mesh: Mesh, axis: str = "x"):
    """Traceable halo-exchange banded matvec (x sharded P(axis)); A is an
    argument so jitted callers pass it as an operand."""
    from libhpc_tpu.ops.spmv import dia_spmv

    h = A.maxoff
    rows_local = A.rows_local
    width = rows_local + 2 * h

    def body(dd, x):
        x_l = x.reshape(-1)
        n = lax.axis_size(axis)
        if h > 0:
            fwd = [(i, i + 1) for i in range(n - 1)]
            bwd = [(i + 1, i) for i in range(n - 1)]
            left = lax.ppermute(x_l[-h:], axis, fwd)   # from neighbor i-1
            right = lax.ppermute(x_l[:h], axis, bwd)   # from neighbor i+1
            xw = jnp.concatenate([left, x_l, right])
        else:
            xw = x_l
        dia = DIA(data=dd[0], offsets=A.offsets, shape=(rows_local, width))
        return dia_spmv(dia, xw)

    smapped = jax.shard_map(
        body, mesh=mesh, in_specs=(P(axis), P(axis)), out_specs=P(axis)
    )
    return smapped(A.data, x)


def dist_dia_spmv_fn(A: DistDIA, mesh: Mesh, axis: str = "x"):
    """The jitted halo-exchange banded matvec x -> A @ x."""
    return partial(
        jax.jit(partial(dist_dia_spmv_apply, mesh=mesh, axis=axis)), A)


def dist_dia_cg(A: DistDIA, b, mesh: Mesh, axis: str = "x",
                tol: float = 1e-6, max_iter: int = 1000):
    from libhpc_tpu.ops.solver import cg

    @jax.jit
    def run(A, b):
        return cg(partial(dist_dia_spmv_apply, A, mesh=mesh, axis=axis), b,
                  tol=tol, max_iter=max_iter)

    return run(A, b)
