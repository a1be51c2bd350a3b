"""Exclusive / inclusive scans.

Descendant of the reference's hierarchical 1024-fan-in exclusive scan
(lib/gpu/radix_gpu/include/cuda_hierarchical_exclusive_scan_localT_1024.cuh,
SURVEY.md §2.11c). XLA lowers `cumsum` to its own parallel scan on every
backend, so the upsweep/downsweep tree is one library call here.

Public API:
  exclusive_scan(x)  — exclusive prefix sum along the last axis
  inclusive_scan(x)  — inclusive prefix sum along the last axis
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def exclusive_scan(x):
    """Exclusive prefix sum along the last axis (XLA path)."""
    c = jnp.cumsum(x, axis=-1)
    return c - x


@jax.jit
def inclusive_scan(x):
    return jnp.cumsum(x, axis=-1)
