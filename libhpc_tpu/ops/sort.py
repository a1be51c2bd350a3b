"""Radix sort — the reference's flagship, re-expressed in JAX.

The reference builds a 4-round × 8-bit LSD radix sort with a
count → hierarchical-scan → rank-stable-scatter pipeline on GPU
(lib/gpu/radix_gpu, SURVEY.md §3.1) and a two-level per-thread variant on CPU
(lib/sort/radix_cpu/include/radix_sort_cpu.hpp:254-322, §3.2).

The production path is XLA's own sort: on the GPU, XLA hands a large
1-D key (or key-index) sort to a library radix sort, which is the
reference's pipeline as a tuned library call. So:

  sort_u32 / radix_sort  — production path: `jax.lax.sort`
  radix_sort_pipeline    — the count→scan→scatter pipeline built from this
                           package's histogram/scan/segment primitives, with
                           the same two-level (tile-local + global-base)
                           position math as the reference's cache_thread_v2.
                           Exists for parity + stage-level testability; each
                           stage is oracle-tested like the reference's
                           per-stage GPU tests (§4.1).
  argsort_u32            — stable argsort (key, index) pairs

All functions are stable and handle arbitrary (non-multiple-of-tile) sizes —
the reference's edge-size sweep {1, 111, 256, 297, 500, 512, 3987, 262201}
is part of the test matrix.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from libhpc_tpu.ops._util import cdiv

TILE = 2048  # elements per tile in the pipeline variant


@jax.jit
def sort_u32(x):
    """Sort uint32 ascending — production path (XLA sort)."""
    return jax.lax.sort(x.astype(jnp.uint32))


# public alias matching the reference API name (radix_sort_cpu.hpp:325-332)
radix_sort = sort_u32


@jax.jit
def argsort_u32(x):
    """Stable ascending argsort; returns (sorted, order)."""
    n = x.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    s, order = jax.lax.sort((x.astype(jnp.uint32), idx), num_keys=1,
                            is_stable=True)
    return s, order


@jax.jit
def is_sorted(x):
    if x.shape[0] <= 1:
        return jnp.bool_(True)
    return jnp.all(x[1:] >= x[:-1])


# ---------------------------------------------------------------------------
# The explicit count→scan→scatter pipeline (parity path)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("bits_per_pass",))
def digit_of(x, shift, bits_per_pass: int = 8):
    """Extract the radix digit — stage 0 of the pipeline."""
    mask = jnp.uint32((1 << bits_per_pass) - 1)
    return ((x.astype(jnp.uint32) >> shift) & mask).astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_bins", "tile"))
def tile_histograms(digits, n_bins: int = 256, tile: int = TILE):
    """local[tile][bin] — the reference's kernel_local_histogram stage
    (cuda_local_histogram.cuh:43-92). Padding (digit == n_bins) not counted."""
    from libhpc_tpu.ops.histogram import local_histogram

    return local_histogram(digits, n_bins=n_bins, tile=tile)


@jax.jit
def global_base_from_local(local_hist):
    """Exclusive scan of per-bin totals — the reference's
    global-reduce (v3 tree) + thrust::exclusive_scan stages
    (cuda_radix_sort_v4.cu:142-183)."""
    totals = jnp.sum(local_hist, axis=0)
    return jnp.cumsum(totals) - totals


@jax.jit
def tile_offsets_from_local(local_hist):
    """offset[tile][bin]: elements of the same bin in *earlier tiles* — the
    reference's hierarchical per-bin scan over localT
    (hierarchical_exclusive_scan_localT_1024, cuda_radix_sort_v4.cu:193).
    Computed as an exclusive scan down the tile axis (bin-major)."""
    return jnp.cumsum(local_hist, axis=0) - local_hist


@partial(jax.jit, static_argnames=("n_bins", "tile"))
def _rank_within_tiles(digits, n_bins: int = 256, tile: int = TILE):
    """rank[i]: occurrences of digit[i] earlier in i's tile — the reference's
    warp-aggregated rank (cuda_radix_scatter.cuh:60-75) without warps:
    a per-tile one-hot cumulative count, looped over tiles with lax.map to
    bound memory to O(tile × n_bins) per step."""
    n = digits.shape[0]
    n_tiles = max(1, cdiv(n, tile))
    # pad with out-of-range digit so pad elements rank into nothing real
    dp = jnp.full((n_tiles * tile,), n_bins, jnp.int32).at[:n].set(digits)
    dt = dp.reshape(n_tiles, tile)

    def one_tile(d):
        onehot = (
            d[:, None] == jnp.arange(n_bins, dtype=jnp.int32)[None, :]
        ).astype(jnp.int32)
        excl = jnp.cumsum(onehot, axis=0) - onehot
        return jnp.take_along_axis(excl, d[:, None] % n_bins, axis=1)[:, 0]

    ranks = jax.lax.map(one_tile, dt)
    return ranks.reshape(-1)[:n]


@partial(jax.jit, static_argnames=("bits_per_pass", "tile"))
def radix_sort_pipeline(x, bits_per_pass: int = 8, tile: int = TILE):
    """Full multi-pass LSD radix sort via the explicit pipeline.

    Per pass (mirrors SURVEY.md §3.2's count→scan→scatter skeleton):
      1. digits        = (x >> shift) & mask
      2. local[t][b]   = tile histograms
      3. base[b]       = exclusive scan of global bin totals
      4. offs[t][b]    = per-bin exclusive scan across tiles
      5. rank[i]       = stable rank within (tile, bin)
      6. pos[i]        = base[digit] + offs[tile][digit] + rank[i]
      7. scatter       = out.at[pos].set(x)
    """
    x = x.astype(jnp.uint32)
    n = x.shape[0]
    if n <= 1:
        return x
    n_bins = 1 << bits_per_pass
    n_passes = cdiv(32, bits_per_pass)
    tile_ids = jnp.arange(n, dtype=jnp.int32) // tile

    def one_pass(x, shift):
        digits = digit_of(x, shift, bits_per_pass)
        local = tile_histograms(digits, n_bins=n_bins, tile=tile)
        base = global_base_from_local(local)
        offs = tile_offsets_from_local(local)
        rank = _rank_within_tiles(digits, n_bins=n_bins, tile=tile)
        pos = base[digits] + offs[tile_ids, digits] + rank
        return jnp.zeros_like(x).at[pos].set(x)

    for p in range(n_passes):
        x = one_pass(x, jnp.uint32(p * bits_per_pass))
    return x


# ---------------------------------------------------------------------------
# Bitonic sort network (vectorized butterfly stages)
# ---------------------------------------------------------------------------


@jax.jit
def bitonic_sort(x):
    """Full bitonic sort network in vectorized XLA ops.

    Every compare-exchange stage at distance d is a reshape to
    (n/2d, 2, d) + min/max + direction select — pure elementwise work with zero
    gather/scatter (the butterfly partner i XOR d is reached by layout, the
    same trick as the reference's warp-shuffle exchanges). log²(n)/2 stages,
    unrolled at trace time; pads to a power of two with UINT32_MAX.

    Exists as (a) the network formulation `lax.sort` itself uses under the
    hood — here inspectable and tunable — and (b) the base of a future
    merge-path large sort (ROADMAP #2).
    """
    x = x.astype(jnp.uint32)
    n = x.shape[0]
    if n <= 1:
        return x
    k = max(1, (n - 1).bit_length())
    n_pad = 1 << k
    xp = jnp.full((n_pad,), jnp.uint32(0xFFFFFFFF)).at[:n].set(x)

    for k2 in range(1, k + 1):          # bitonic run length 2^k2
        run = 1 << k2
        for sub in range(k2 - 1, -1, -1):
            d = 1 << sub
            v = xp.reshape(n_pad // (2 * d), 2, d)
            blk = jnp.arange(n_pad // (2 * d), dtype=jnp.uint32)
            # ascending iff the element's position / run is even
            asc = (((blk * 2 * d) // run) % 2 == 0)[:, None]
            a, b = v[:, 0, :], v[:, 1, :]
            mn, mx = jnp.minimum(a, b), jnp.maximum(a, b)
            v = jnp.stack(
                [jnp.where(asc, mn, mx), jnp.where(asc, mx, mn)], axis=1
            )
            xp = v.reshape(n_pad)
    return xp[:n]
