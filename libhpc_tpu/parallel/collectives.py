"""Thin collective wrappers over `jax.lax` (used inside shard_map bodies).

The replacement for the reference's hierarchical reduce/scan trees
(cuda_global_reduce_from_local.cuh:60-120): the cross-device level of
every reduction is a `psum`/`psum_scatter` over a mesh axis; XLA lowers
these to the backend's collectives (NCCL on GPUs). Neighbor exchange (`shift_up`/`shift_down`)
is the halo-exchange primitive built on `ppermute`.
"""

from __future__ import annotations

import jax
from jax import lax


def all_reduce_sum(x, axis: str):
    return lax.psum(x, axis)


def all_gather(x, axis: str, tiled: bool = True):
    return lax.all_gather(x, axis, tiled=tiled)


def reduce_scatter(x, axis: str):
    return lax.psum_scatter(x, axis, tiled=True)


def shift_up(x, axis: str, wrap: bool = False):
    """Send shard to neighbor i+1; receive from i-1 (zeros at the boundary
    unless wrap). The distributed ghost-cell fill."""
    n = lax.axis_size(axis)
    perm = [(i, (i + 1) % n) for i in range(n if wrap else n - 1)]
    y = lax.ppermute(x, axis, perm)
    return y


def shift_down(x, axis: str, wrap: bool = False):
    """Send shard to neighbor i-1; receive from i+1."""
    n = lax.axis_size(axis)
    perm = [((i + 1) % n, i) for i in range(n if wrap else n - 1)]
    return lax.ppermute(x, axis, perm)


def my_index(axis: str):
    return lax.axis_index(axis)
