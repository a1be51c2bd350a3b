"""Histogram / binning kernels.

Descendant of the reference's local-histogram CUDA kernels
(lib/gpu/radix_gpu/include/cuda_local_histogram.cuh:13-92): the global
histogram is an XLA segment-sum, the per-tile stage one-hot comparisons
reduced per tile.

Public API:
  histogram(x, n_bins)            — XLA path (segment_sum of ones)
  local_histogram(x, n_bins, tile)— per-tile histograms (T, n_bins), the
                                    'local' stage of the radix pipeline
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from libhpc_tpu.ops._util import cdiv

TILE = 1024


@partial(jax.jit, static_argnames=("n_bins",))
def histogram(x, n_bins: int = 256):
    """Global histogram of integer values in [0, n_bins)."""
    return jax.ops.segment_sum(
        jnp.ones_like(x, jnp.int32), x.astype(jnp.int32), num_segments=n_bins
    )


@partial(jax.jit, static_argnames=("n_bins", "tile"))
def local_histogram(x, n_bins: int = 256, tile: int = TILE):
    """Per-tile histograms: (n_tiles, n_bins), zero-padded final tile.

    Padding uses bin value n_bins (out of range) so it is *not counted* —
    mirroring the reference's IgnoresPadding tests where pad=UINT32_MAX
    lands outside the measured digit range.
    """
    (n,) = x.shape
    n_tiles = max(1, cdiv(n, tile))
    xp = jnp.full((n_tiles * tile,), n_bins, jnp.int32).at[:n].set(
        x.astype(jnp.int32)
    )
    xt = xp.reshape(n_tiles, tile)
    onehot = (
        xt[:, :, None] == jnp.arange(n_bins, dtype=jnp.int32)[None, None, :]
    )
    return jnp.sum(onehot, axis=1, dtype=jnp.int32)
