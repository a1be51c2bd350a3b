"""Ghost-cell stencils.

Re-expression of the reference's stencil-blur workload ladder
(tests/test_hpc_benchmark/test_hpc_benchmark.cpp:354-601: naive → prefetch →
tiling → SIMD → ILP over an 8192×8192, radius-8 box blur) and of the
ghost-cell machinery of HPCHighDimensionFlatArray
(lib/hpc/include/HPCHighDimensionFlatArray.hpp:54-57 — per-dim Low/High halo
bounds addressed with negative indices).

Design:
- XLA paths use the running-sum (cumsum-difference) sliding window: O(N)
  independent of radius, strictly better than the reference's O(N·r) SIMD
  ladder — algorithmic win instead of instruction-level tuning.
- `poisson5_apply` is the matrix-free 5-point operator matching the CSR
  Poisson matrix (used to cross-validate SpMV and feed matrix-free CG).

Halos here are zero-filled (Dirichlet); the distributed path replaces the
zero fill with `ppermute` neighbor exchange.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from libhpc_tpu.containers import HaloArray


# ---------------------------------------------------------------------------
# Shared ghost-cell stencil kernels: HaloArray -> interior-shaped result.
# The single-chip paths below wrap with zero (Dirichlet) halos; the
# distributed paths (parallel/dist_stencil.py) feed the SAME kernels
# HaloArrays whose ghost cells came from ppermute neighbor exchange —
# one definition of "ghost cells" for both.
# ---------------------------------------------------------------------------


def box_sum_halo(h: HaloArray, radius: int, axis: int):
    """Sliding-window sum of width 2r+1 along `axis`; needs halo >= r+1 low
    and >= r high on that axis (running-sum form: O(N) independent of r,
    an algorithmic win over the reference's O(N*r) SIMD ladder)."""
    r = radius
    n = h.interior_shape[axis]
    a0 = h.lo[axis] - r - 1   # padded-coord start of the window we use
    sl = [slice(l, l + s) for l, s in zip(h.lo, h.interior_shape)]
    sl[axis] = slice(a0, a0 + n + 2 * r + 1)
    c = jnp.cumsum(h.data[tuple(sl)], axis=axis)
    hi = jax.lax.slice_in_dim(c, 2 * r + 1, 2 * r + 1 + n, axis=axis)
    lo = jax.lax.slice_in_dim(c, 0, n, axis=axis)
    return hi - lo


def poisson5_halo(h: HaloArray):
    """Matrix-free 5-point operator on a (1,1)-haloed 2D field."""
    return (4.0 * h.interior
            - h.shift((-1, 0)) - h.shift((1, 0))
            - h.shift((0, -1)) - h.shift((0, 1)))


def poisson7_halo(h: HaloArray):
    """Matrix-free 7-point operator on a (1,1,1)-haloed 3D field."""
    return (6.0 * h.interior
            - h.shift((-1, 0, 0)) - h.shift((1, 0, 0))
            - h.shift((0, -1, 0)) - h.shift((0, 1, 0))
            - h.shift((0, 0, -1)) - h.shift((0, 0, 1)))


@partial(jax.jit, static_argnames=("radius", "axis"))
def box_sum_1d(a, radius: int, axis: int):
    """Sliding-window sum of width 2r+1 along `axis`, zero halo."""
    lo = [0] * a.ndim
    hi = [0] * a.ndim
    lo[axis] = radius + 1
    hi[axis] = radius
    return box_sum_halo(HaloArray.wrap(a, tuple(lo), tuple(hi)),
                        radius, axis)


@partial(jax.jit, static_argnames=("radius",))
def blur_x(a, radius: int = 8):
    """Reference BM_*_blur_x equivalent: sum over a(y, x±r)."""
    return box_sum_1d(a, radius, axis=1)


@partial(jax.jit, static_argnames=("radius",))
def blur_y(a, radius: int = 8):
    return box_sum_1d(a, radius, axis=0)


@partial(jax.jit, static_argnames=("radius",))
def blur2d(a, radius: int = 8):
    """Separable 2D box sum (X then Y)."""
    return blur_y(blur_x(a, radius), radius)


@jax.jit
def poisson5_apply(u):
    """Matrix-free 5-point Poisson operator: 4u - u_N - u_S - u_E - u_W,
    zero Dirichlet halo. Matches libhpc_tpu.bench.matrices.poisson2d."""
    return poisson5_halo(HaloArray.wrap(u, 1))


@jax.jit
def poisson7_apply(u):
    """Matrix-free 7-point 3D Poisson operator: 6u - sum of 6 face
    neighbors, zero Dirichlet halo. Matches
    libhpc_tpu.bench.matrices.poisson3d."""
    return poisson7_halo(HaloArray.wrap(u, 1))
