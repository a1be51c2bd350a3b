"""Segmented and hierarchical reductions.

Descendant of the reference's global-reduce tree kernels
(lib/gpu/radix_gpu/include/cuda_global_reduce_from_local.cuh:60-120 — the
hierarchical 1024-fan-in multi-pass reduce): the tree collapses into XLA
`segment_sum` / reductions, and the cross-device level becomes
`jax.lax.psum` over a mesh axis (libhpc_tpu.parallel.collectives).

Public API:
  segment_sum / segment_max / segment_min — thin, num_segments-static wrappers
  tree_reduce_sum(x)   — explicit hierarchical 1024-fan-in reduction (parity
                         with the reference's multi-pass loop; same result as
                         jnp.sum but exercises the tiled path)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from libhpc_tpu.ops._util import cdiv

FAN_IN = 1024  # same fan-in as the reference tree


@partial(jax.jit, static_argnames=("num_segments",))
def segment_sum(data, segment_ids, num_segments: int):
    return jax.ops.segment_sum(data, segment_ids, num_segments=num_segments)


@partial(jax.jit, static_argnames=("num_segments",))
def segment_max(data, segment_ids, num_segments: int):
    return jax.ops.segment_max(data, segment_ids, num_segments=num_segments)


@partial(jax.jit, static_argnames=("num_segments",))
def segment_min(data, segment_ids, num_segments: int):
    return jax.ops.segment_min(data, segment_ids, num_segments=num_segments)


@jax.jit
def tree_reduce_sum(x):
    """Multi-pass 1024-fan-in sum — the reference's reduce-until-one loop
    (cuda_global_reduce_from_local.cuh:60-120) expressed with static shapes.

    Each pass pads to a multiple of FAN_IN and sums FAN_IN-wide groups; the
    number of passes is static (derived from input size).
    """
    x = x.reshape(-1)
    while x.shape[0] > 1:
        n = x.shape[0]
        n_pad = cdiv(n, FAN_IN) * FAN_IN
        xp = jnp.zeros((n_pad,), x.dtype).at[:n].set(x)
        x = jnp.sum(xp.reshape(n_pad // FAN_IN, FAN_IN), axis=1)
    return x[0]
