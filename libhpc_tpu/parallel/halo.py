"""Distributed halo exchange (SURVEY.md §5.7 → the build's new work).

The reference's ghost cells (HPCHighDimensionFlatArray Low/High bounds,
lib/hpc/include/HPCHighDimensionFlatArray.hpp:54-57) become per-shard halo
rows refreshed from mesh neighbors with `ppermute`. The overlap discipline
descends from the reference's stream-overlap study
(lib/gpu/transfer_overlap_testsuite/src/cuda_tut_transfer_overlap.cu:41-142):
start the exchange, compute the interior while it is in flight, then finish
the boundary — XLA schedules the async collective across the interior
compute exactly like pattern-A stream pipelining.

All functions run *inside* shard_map: `x` is the local shard.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
from jax import lax


def exchange_halo_1d(x, halo: int, axis: str, wrap: bool = False):
    """Return (top_halo, bottom_halo) received from row-neighbors.

    x: local (rows_local, n) shard, partitioned along rows over `axis`.
    top_halo: last `halo` rows of the previous shard (zeros at boundary).
    bottom_halo: first `halo` rows of the next shard.
    """
    n = lax.axis_size(axis)
    fwd = [(i, (i + 1) % n) for i in range(n if wrap else n - 1)]
    bwd = [((i + 1) % n, i) for i in range(n if wrap else n - 1)]
    top = lax.ppermute(x[-halo:, :], axis, fwd)      # from i-1
    bot = lax.ppermute(x[:halo, :], axis, bwd)       # from i+1
    return top, bot


def pad_with_halo(x, halo: int, axis: str, wrap: bool = False):
    """Local shard extended with neighbor ghost rows: (rows+2h, n)."""
    top, bot = exchange_halo_1d(x, halo, axis, wrap)
    return jnp.concatenate([top, x, bot], axis=0)


def exchange_to_halo(x, halo: int, axis: str, wrap: bool = False):
    """Local shard -> HaloArray whose leading-dim ghost cells were refreshed
    from mesh neighbors (ppermute). The distributed counterpart of
    HaloArray.wrap: same container, different ghost-fill policy — stencil
    kernels (ops/stencil.py:*_halo) cannot tell them apart.
    """
    from libhpc_tpu.containers import HaloArray

    lo = (halo,) + (0,) * (x.ndim - 1)
    return HaloArray.from_padded(pad_with_halo(x, halo, axis, wrap), lo, lo)


def halo_stencil_overlapped(x, stencil_fn, halo: int, axis: str,
                            wrap: bool = False):
    """Apply `stencil_fn(padded_block) -> block` with interior/boundary split
    so XLA can overlap the ppermute with the interior compute.

    stencil_fn maps an (m + 2h, n) padded block to the (m, n) stencil result
    (its output row i uses input rows [i, i+2h]).

    The interior rows [h, m-h) of the output depend only on local data; the
    top/bottom h rows need the exchanged halos. Issuing the ppermute first
    and consuming it only in the small boundary computation lets the
    scheduler run the big interior stencil concurrently with the transfer —
    the distributed version of the reference's compute/transfer overlap.
    """
    m = x.shape[0]
    h = halo
    if m < 4 * h:
        # shard too thin to split — simple exchanged-then-compute path
        return stencil_fn(pad_with_halo(x, h, axis, wrap))

    top, bot = exchange_halo_1d(x, h, axis, wrap)   # async-capable collective

    # interior: output rows [h, m-h) ← input rows [0, m)
    interior = stencil_fn(x)[: m - 2 * h, :]  # rows h..m-h of the output

    # boundary strips (consume the halos)
    top_block = jnp.concatenate([top, x[: 3 * h, :]], axis=0)      # (4h, n)
    top_out = stencil_fn(top_block)[:h, :]                          # rows 0..h
    bot_block = jnp.concatenate([x[-3 * h:, :], bot], axis=0)
    bot_out = stencil_fn(bot_block)[-h:, :]                         # last h rows

    return jnp.concatenate([top_out, interior, bot_out], axis=0)


def pad_with_halo_2d(x, halo: int, axes=("py", "px"), wrap: bool = False):
    """2D domain decomposition: extend the local (my, nx) shard with ghost
    rows AND columns from the 4 side neighbors — corners come for free by
    exchanging rows first and then exchanging columns *of the row-extended
    block* (the second exchange carries the first's halo)."""
    ay, ax = axes
    top, bot = exchange_halo_1d(x, halo, ay, wrap)
    xr = jnp.concatenate([top, x, bot], axis=0)      # (my + 2h, nx)
    n = lax.axis_size(ax)
    fwd = [(i, (i + 1) % n) for i in range(n if wrap else n - 1)]
    bwd = [((i + 1) % n, i) for i in range(n if wrap else n - 1)]
    left = lax.ppermute(xr[:, -halo:], ax, fwd)      # from col-neighbor j-1
    right = lax.ppermute(xr[:, :halo], ax, bwd)      # from col-neighbor j+1
    return jnp.concatenate([left, xr, right], axis=1)
