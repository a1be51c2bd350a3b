"""Striped block-ELL (SBELL) SpMV: a Pallas kernel through Triton, and the
plain XLA form of the same product.

y = A @ x for an SBELL matrix (sparse/sbell.py). Vectors live in the
GUARDED PANE layout x3[p, j, l] = x[1024 p + 8 l + j], shape
(n_panes + W_PANES - 1, 8, 128) with zero guard panes at the end; the
output (n_stripes + W_PANES - 1, 8, 128) follows the same convention
over y, so a square operator's output feeds the next matvec directly.

  kernel  (`impl="kernel"`, one pallas_call, backend="triton"): the grid
          is (guarded stripes, n_split). Program (s, k) walks tiles
          tptr[s] + k, tptr[s] + k + n_split, ... of its stripe; per tile
          it loads the (64, 128) value plane as eight coalesced (8, 128)
          rows, gathers the tile's eight (128,) x rows straight from
          device memory (x is a few MB, L2-resident; the pane layout
          makes consecutive slots near-contiguous), converts bf16 values
          in registers and accumulates f32 in registers. It writes its
          (8, 128) output block once. Stripes are split over n_split
          programs when there are too few stripes to fill the card; the
          partial planes are then summed by one XLA reduction (a second
          pass, deterministic — no atomics).
  xla     (`impl="xla"`): gather + per-tile 8-term multiply-sum +
          sorted segment-sum over stripes. Runs on any backend and is
          the oracle the kernel is tested against.

The far set (sparse/sbell.py:FarBlocks) goes through one XLA gather +
multiply-sum + scatter-add in the same pane layout in both forms.

`impl=None` takes the kernel on a GPU and the XLA form elsewhere. The
kernel compiles for CUDA GPUs only: called without `interpret=True` on
another backend it raises (tests run it in the Pallas interpreter).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from libhpc_tpu.sparse.sbell import (B, LANE, PANE_COLS, SBELL, VROWS,
                                     W_PANES)

# programs the split aims for: a few per SM of a 132-SM card, so that
# stripes with few tiles (cant: ~60 stripes) still fill the card
TARGET_PROGRAMS = 512


def n_split_for(sb: SBELL) -> int:
    """Programs per stripe: enough to reach TARGET_PROGRAMS, never more
    than the mean tiles per stripe (static: from shapes only)."""
    per_stripe = -(-sb.n_tiles // max(sb.n_stripes, 1))
    want = -(-TARGET_PROGRAMS // sb.n_guarded)
    return max(1, min(want, per_stripe))


def _kernel(tptr_ref, pane_ref, meta_ref, v_ref, x_ref, o_ref, *,
            n_split: int):
    s = pl.program_id(0)
    k = pl.program_id(1)
    t0 = tptr_ref[s]
    n_it = jnp.maximum((tptr_ref[s + 1] - t0 - k + n_split - 1) // n_split,
                       0)

    def tile(it, acc):
        t = t0 + k + it * n_split
        c = pane_ref[t] * LANE + meta_ref[t, :]          # (128,) block col
        base = (c >> 7) * PANE_COLS + (c & (LANE - 1))   # x3 flat offset
        for j in range(B):
            xj = x_ref[base + j * LANE]                   # (128,) gather
            vj = v_ref[pl.ds(t * VROWS + j * B, B), :]    # (8, 128) rows
            acc = acc + vj.astype(jnp.float32) * xj[None, :]
        return acc

    acc = jax.lax.fori_loop(0, n_it, tile, jnp.zeros((B, LANE), jnp.float32))
    o_ref[pl.ds((k * pl.num_programs(0) + s) * B, B), :] = acc


@partial(jax.jit, static_argnames=("n_guarded", "n_split", "interpret"))
def _kernel_call(tptr, pane, meta, vflat, x3, *, n_guarded: int,
                 n_split: int, interpret: bool):
    out = pl.pallas_call(
        partial(_kernel, n_split=n_split),
        grid=(n_guarded, n_split),
        out_shape=jax.ShapeDtypeStruct((n_split * n_guarded * B, LANE),
                                       jnp.float32),
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=4),
        interpret=interpret,
        name="sbell_spmv",
    )(tptr, pane, meta, vflat, x3.reshape(-1))
    out = out.reshape(n_split, n_guarded, B, LANE)
    return out[0] if n_split == 1 else out.sum(axis=0)


def near_kernel(sb: SBELL, x3: jax.Array, *, n_split: int | None = None,
                interpret: bool = False) -> jax.Array:
    """Near-tile product by the Triton kernel, guarded pane layout."""
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "sbell_spmv kernel compiles for CUDA GPUs only (backend is "
            f"{jax.default_backend()!r}); pass interpret=True to run it "
            "in the Pallas interpreter, or impl='xla'")
    return _kernel_call(sb.tptr, sb.pane, sb.meta, sb.vflat, x3,
                        n_guarded=sb.n_guarded,
                        n_split=n_split or n_split_for(sb),
                        interpret=interpret)


def near_xla(sb: SBELL, x3: jax.Array) -> jax.Array:
    """Near-tile product in plain XLA, guarded pane layout."""
    c = sb.pane[:, None] * LANE + sb.meta                     # (T, 128)
    base = (c >> 7) * PANE_COLS + (c & (LANE - 1))
    jj = jnp.arange(B, dtype=jnp.int32)[None, :, None] * LANE
    gx = x3.reshape(-1)[base[:, None, :] + jj]                # (T, 8j, 128)
    v = sb.vflat.reshape(-1, B, B, LANE).astype(jnp.float32)  # [t,j,i,slot]
    prod = jnp.sum(v * gx[:, :, None, :], axis=1)             # (T, 8i, 128)
    return jax.ops.segment_sum(prod, sb.sid, num_segments=sb.n_guarded,
                               indices_are_sorted=True)


def far_panes(far, x3: jax.Array, n_guarded: int) -> jax.Array:
    """Far block-COO contribution in guarded pane layout: one gather of
    each block's 8 x entries, an 8-term multiply-sum in f32, one
    scatter-add of its 8 outputs."""
    jj = jnp.arange(B, dtype=jnp.int32)[None, :] * LANE
    xin = (far.cols >> 7) * PANE_COLS + (far.cols & (LANE - 1))
    gx = x3.reshape(-1)[xin[:, None] + jj]                    # (nf, 8j)
    prod = jnp.sum(far.blocks.astype(jnp.float32) * gx[:, None, :],
                   axis=2)                                    # (nf, 8i)
    oin = (far.rows >> 7) * PANE_COLS + (far.rows & (LANE - 1))
    out = jnp.zeros((n_guarded * PANE_COLS,), jnp.float32)
    out = out.at[oin[:, None] + jj].add(prod)
    return out.reshape(n_guarded, B, LANE)


def default_impl() -> str:
    """The kernel on a GPU, the XLA form on any other backend."""
    return "kernel" if jax.default_backend() == "gpu" else "xla"


def x_to_panes(sb: SBELL, xpad: jax.Array) -> jax.Array:
    """Padded flat x -> GUARDED pane layout (n_panes + W_PANES - 1, 8,
    128): x3[p, j, l] = x[1024 p + 8 l + j], trailing guard panes zero."""
    x3 = xpad.reshape(sb.n_panes, LANE, B).transpose(0, 2, 1)
    return jnp.pad(x3, ((0, W_PANES - 1), (0, 0), (0, 0)))


def panes_to_x(sb: SBELL, out3: jax.Array) -> jax.Array:
    """Guarded output pane layout -> padded flat y."""
    return out3[:sb.n_stripes].transpose(0, 2, 1).reshape(-1)


def sbell_spmv_panes(sb: SBELL, x3: jax.Array, *, impl: str | None = None,
                     interpret: bool = False) -> jax.Array:
    """y = A @ x entirely in GUARDED pane layout (module docstring). The
    guard stripes of the result are zero, so for square matrices it is
    the next matvec's input with zero wrapper ops; iterative solvers keep
    vectors in this layout across iterations."""
    impl = impl or default_impl()
    if impl == "kernel":
        out = near_kernel(sb, x3, interpret=interpret)
    elif impl == "xla":
        out = near_xla(sb, x3)
    else:
        raise ValueError(f"impl must be 'kernel' or 'xla', got {impl!r}")
    if sb.far is not None:
        out = out + far_panes(sb.far, x3, sb.n_guarded)
    return out


def sbell_spmv_padded(sb: SBELL, xpad: jax.Array, **kw) -> jax.Array:
    """y = A @ x in the PADDED domain: xpad is (n_panes*1024,) f32 and the
    result has n_stripes*1024 entries (zero pad rows/cols are inert)."""
    return panes_to_x(sb, sbell_spmv_panes(sb, x_to_panes(sb, xpad), **kw))


def sbell_spmv(sb: SBELL, x: jax.Array, **kw) -> jax.Array:
    """y = A @ x for SBELL A. x is f32 (ncols,); returns f32 (nrows,).
    Keyword arguments go to sbell_spmv_panes."""
    m, n = sb.shape
    xpad = jnp.pad(x, (0, sb.n_panes * PANE_COLS - n))
    return sbell_spmv_padded(sb, xpad, **kw)[:m]
