"""Distributed (row-partitioned) SBELL SpMV — unstructured FEM matrices
across the mesh.

Extends the DistCSR overlap discipline (parallel/dist_spmv.py) to the
SBELL fast path (ops/spmv_pallas.py): each shard owns a contiguous block
of rows and splits its matrix slice into

  diag — the column block the shard also owns x for: SpMV runs on the
         LOCAL x while the all_gather is in flight;
  offd — every other column (full-width SBELL): consumes the gathered x.

This is the BASELINE.json weak-scaling workload (configs[2]: 100M-nnz
unstructured SpMV across devices) on the same matvec as one device.
Setup is host-side scipy (one-time); the hot path is one jitted shard_map
program whose per-shard compute is the SBELL matvec.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libhpc_tpu.ops.spmv_pallas import sbell_spmv
from libhpc_tpu.sparse.sbell import (FarBlocks, SBELL, STRIPE_ROWS, VROWS,
                                     tile_pointer)


def _pad_sbell_tiles(sb: SBELL, n_tiles: int) -> SBELL:
    """Zero-pad a shard's tile stream so every shard has the same count.
    Padding tiles join the first guard stripe (inert: zero values)."""
    extra = n_tiles - sb.n_tiles
    if extra == 0:
        return sb
    sid = jnp.pad(sb.sid, (0, extra), constant_values=sb.n_stripes)
    return dataclasses.replace(
        sb,
        vflat=jnp.pad(sb.vflat, ((0, extra * VROWS), (0, 0))),
        meta=jnp.pad(sb.meta, ((0, extra), (0, 0))),
        pane=jnp.pad(sb.pane, (0, extra)),
        sid=sid,
        tptr=jnp.asarray(tile_pointer(np.asarray(sid), sb.n_guarded)),
    )


def _pad_far(f: FarBlocks | None, nf: int, shape) -> FarBlocks:
    """Uniform-length (possibly empty) far block-COO so shards stack.

    Padding entries are zero blocks aimed at (row 0, col 0) — harmless
    under the far set's scatter-add (ops/spmv_pallas.py:far_panes)."""
    have = 0 if f is None else f.n_far
    extra = nf - have
    if f is None:
        return FarBlocks(rows=jnp.zeros((nf,), jnp.int32),
                         cols=jnp.zeros((nf,), jnp.int32),
                         blocks=jnp.zeros((nf, 8, 8), jnp.float32),
                         shape=shape)
    if extra == 0:
        return f
    return FarBlocks(rows=jnp.pad(f.rows, (0, extra)),
                     cols=jnp.pad(f.cols, (0, extra)),
                     blocks=jnp.pad(f.blocks, ((0, extra), (0, 0), (0, 0))),
                     shape=shape)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class DistSBELL:
    """Row-partitioned SBELL, stacked over shards (leading dim = S).

    diag_*: the shard's own column block (consumes local x)
    offd_*: all other columns, full width (consumes gathered x)
    """

    diag_vflat: jax.Array
    diag_meta: jax.Array
    diag_pane: jax.Array
    diag_sid: jax.Array
    diag_tptr: jax.Array
    offd_vflat: jax.Array
    offd_meta: jax.Array
    offd_pane: jax.Array
    offd_sid: jax.Array
    offd_tptr: jax.Array
    far_rows: jax.Array      # (S, nf) far block-COO (zero-block padded)
    far_cols: jax.Array      # (S, nf)
    far_blocks: jax.Array    # (S, nf, 8, 8)
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    stripes_local: int = dataclasses.field(metadata=dict(static=True))
    has_far: bool = dataclasses.field(metadata=dict(static=True))

    @property
    def rows_local(self) -> int:
        return self.stripes_local * STRIPE_ROWS

    @staticmethod
    def from_scipy(sp, n_shards: int) -> "DistSBELL":
        import scipy.sparse as sps

        sp = sps.csr_matrix(sp)
        nr, nc = sp.shape
        if nr != nc:
            raise ValueError("row partitioning assumes a square matrix")
        stripes_local = -(-nr // (n_shards * STRIPE_ROWS))
        rows_local = stripes_local * STRIPE_ROWS
        n_pad = rows_local * n_shards
        if n_pad != nr:
            sp = sps.csr_matrix((sp.data, sp.indices, sp.indptr),
                                shape=(nr, n_pad))
            sp.resize((n_pad, n_pad))
        nr = nc = n_pad

        diags, offds = [], []
        for s in range(n_shards):
            r0, r1 = s * rows_local, (s + 1) * rows_local
            blk = sp[r0:r1, :].tocsc()
            d = blk[:, r0:r1].tocsr()
            o = sps.hstack(
                [blk[:, :r0], sps.csr_matrix((rows_local, rows_local)),
                 blk[:, r1:]]).tocsr()
            # flat far form: the shard merger below re-stacks FarBlocks
            diags.append(SBELL.from_scipy(d))
            offds.append(SBELL.from_scipy(o))

        dt = max(sb.n_tiles for sb in diags)
        ot = max(sb.n_tiles for sb in offds)
        diags = [_pad_sbell_tiles(sb, dt) for sb in diags]
        offds = [_pad_sbell_tiles(sb, ot) for sb in offds]
        has_far = any(sb.far is not None for sb in offds + diags)
        # fold any diag far set into the offd far set (both consume xg in
        # the worst case; diag far is rare — only thin clusters)
        nf_max = 1
        fars = []
        for s in range(n_shards):
            parts = []
            if diags[s].far is not None:
                # diag far indices are local block-cols: shift to global.
                d = diags[s].far
                parts.append(FarBlocks(
                    rows=d.rows, cols=d.cols + (s * rows_local) // 8,
                    blocks=d.blocks, shape=(rows_local, nc)))
                diags[s] = dataclasses.replace(diags[s], far=None)
            if offds[s].far is not None:
                o = offds[s].far
                parts.append(FarBlocks(rows=o.rows, cols=o.cols,
                                       blocks=o.blocks,
                                       shape=(rows_local, nc)))
            if len(parts) == 2:
                merged = FarBlocks(
                    rows=jnp.concatenate([p.rows for p in parts]),
                    cols=jnp.concatenate([p.cols for p in parts]),
                    blocks=jnp.concatenate([p.blocks for p in parts]),
                    shape=(rows_local, nc))
            elif parts:
                merged = parts[0]
            else:
                merged = None
            fars.append(merged)
            if merged is not None:
                nf_max = max(nf_max, merged.n_far)
        fars = [_pad_far(f, nf_max, (rows_local, nc)) for f in fars]

        stack = lambda xs: jnp.stack(xs)
        return DistSBELL(
            diag_vflat=stack([sb.vflat for sb in diags]),
            diag_meta=stack([sb.meta for sb in diags]),
            diag_pane=stack([sb.pane for sb in diags]),
            diag_sid=stack([sb.sid for sb in diags]),
            diag_tptr=stack([sb.tptr for sb in diags]),
            offd_vflat=stack([sb.vflat for sb in offds]),
            offd_meta=stack([sb.meta for sb in offds]),
            offd_pane=stack([sb.pane for sb in offds]),
            offd_sid=stack([sb.sid for sb in offds]),
            offd_tptr=stack([sb.tptr for sb in offds]),
            far_rows=stack([f.rows for f in fars]),
            far_cols=stack([f.cols for f in fars]),
            far_blocks=stack([f.blocks for f in fars]),
            shape=(nr, nc), n_shards=n_shards,
            stripes_local=stripes_local, has_far=has_far,
        )

    def shard(self, mesh: Mesh, axis: str = "x") -> "DistSBELL":
        sh = NamedSharding(mesh, P(axis))
        put = lambda a: jax.device_put(a, sh)
        return dataclasses.replace(
            self,
            diag_vflat=put(self.diag_vflat), diag_meta=put(self.diag_meta),
            diag_pane=put(self.diag_pane), diag_sid=put(self.diag_sid),
            diag_tptr=put(self.diag_tptr),
            offd_vflat=put(self.offd_vflat), offd_meta=put(self.offd_meta),
            offd_pane=put(self.offd_pane), offd_sid=put(self.offd_sid),
            offd_tptr=put(self.offd_tptr),
            far_rows=put(self.far_rows), far_cols=put(self.far_cols),
            far_blocks=put(self.far_blocks),
        )


def dist_sbell_spmv_apply(A: DistSBELL, x, mesh: Mesh, axis: str = "x",
                          **spmv_kw):
    """Traceable distributed matvec: x sharded P(axis) -> y sharded P(axis).
    spmv_kw (impl=, interpret=) go to each shard's sbell_spmv. A is an
    argument so jitted callers pass it as an operand.

    all_gather(x) is issued first; the diagonal-block SBELL matvec (local
    x) runs while the gather is in flight; offd consumes the gathered x."""
    rows_local = A.rows_local
    nr, nc = A.shape
    sl = A.stripes_local

    def body(dv, dm, dp, ds, dt, ov, om, op_, os_, ot, fr, fc, fb, x):
        x_l = x.reshape(-1)
        xg = lax.all_gather(x_l, axis, tiled=True)
        sb_d = SBELL(vflat=dv[0], meta=dm[0], pane=dp[0], sid=ds[0],
                     tptr=dt[0], far=None,
                     shape=(rows_local, rows_local), n_stripes=sl,
                     n_panes=rows_local // 1024)
        y = sbell_spmv(sb_d, x_l, **spmv_kw)
        far = FarBlocks(rows=fr[0], cols=fc[0], blocks=fb[0],
                        shape=(rows_local, nc)) if A.has_far else None
        sb_o = SBELL(vflat=ov[0], meta=om[0], pane=op_[0], sid=os_[0],
                     tptr=ot[0], far=far,
                     shape=(rows_local, nc), n_stripes=sl,
                     n_panes=nc // 1024)
        return y + sbell_spmv(sb_o, xg, **spmv_kw)

    # check_vma=False: pallas_call out_shapes don't carry vma annotations
    smapped = jax.shard_map(body, mesh=mesh, in_specs=(P(axis),) * 14,
                            out_specs=P(axis), check_vma=False)
    return smapped(A.diag_vflat, A.diag_meta, A.diag_pane, A.diag_sid,
                   A.diag_tptr, A.offd_vflat, A.offd_meta, A.offd_pane,
                   A.offd_sid, A.offd_tptr, A.far_rows, A.far_cols,
                   A.far_blocks, x)


def dist_sbell_spmv_fn(A: DistSBELL, mesh: Mesh, axis: str = "x",
                       **spmv_kw):
    """The jitted distributed matvec x -> A @ x (dist_sbell_spmv_apply)."""
    return partial(jax.jit(partial(dist_sbell_spmv_apply, mesh=mesh,
                                   axis=axis, **spmv_kw)), A)
