"""Morton (Z-order) codes in pure JAX.

Replacement for the vendored ``libmorton`` the reference consumes
(reference: tests/test_hpc_benchmark/test_hpc_benchmark.cpp:705,722 uses
``libmorton::morton2D_32_decode`` for cache-friendly tiled transposes).

Morton ordering is used here to lay out sparse blocks so that spatially
adjacent tiles are adjacent in memory — the same locality trick, but applied
to BSR block ordering and sparse-grid tile ordering instead of a CPU cache.

All functions are vectorized, jittable, and operate on uint32/int32 arrays.
"""

from __future__ import annotations

import jax.numpy as jnp

_MASKS_2D = (
    jnp.uint32(0x0000FFFF),
    jnp.uint32(0x00FF00FF),
    jnp.uint32(0x0F0F0F0F),
    jnp.uint32(0x33333333),
    jnp.uint32(0x55555555),
)


def _part1by1(x):
    """Spread the low 16 bits of x so there is a zero bit between each."""
    x = jnp.asarray(x, jnp.uint32) & _MASKS_2D[0]
    x = (x | (x << 8)) & _MASKS_2D[1]
    x = (x | (x << 4)) & _MASKS_2D[2]
    x = (x | (x << 2)) & _MASKS_2D[3]
    x = (x | (x << 1)) & _MASKS_2D[4]
    return x


def _compact1by1(x):
    """Inverse of _part1by1: gather every other bit into the low 16 bits."""
    x = jnp.asarray(x, jnp.uint32) & _MASKS_2D[4]
    x = (x | (x >> 1)) & _MASKS_2D[3]
    x = (x | (x >> 2)) & _MASKS_2D[2]
    x = (x | (x >> 4)) & _MASKS_2D[1]
    x = (x | (x >> 8)) & _MASKS_2D[0]
    return x


def morton2d_encode(x, y):
    """Interleave two 16-bit coordinates into one 32-bit Morton code."""
    return _part1by1(x) | (_part1by1(y) << 1)


def morton2d_decode(code):
    """Split a 32-bit Morton code back into (x, y) coordinates."""
    code = jnp.asarray(code, jnp.uint32)
    return _compact1by1(code), _compact1by1(code >> 1)


def _part1by2(x):
    """Spread the low 10 bits of x with two zero bits between each."""
    x = jnp.asarray(x, jnp.uint32) & jnp.uint32(0x000003FF)
    x = (x | (x << 16)) & jnp.uint32(0x030000FF)
    x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
    x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
    x = (x | (x << 2)) & jnp.uint32(0x09249249)
    return x


def _compact1by2(x):
    x = jnp.asarray(x, jnp.uint32) & jnp.uint32(0x09249249)
    x = (x | (x >> 2)) & jnp.uint32(0x030C30C3)
    x = (x | (x >> 4)) & jnp.uint32(0x0300F00F)
    x = (x | (x >> 8)) & jnp.uint32(0x030000FF)
    x = (x | (x >> 16)) & jnp.uint32(0x000003FF)
    return x


def morton3d_encode(x, y, z):
    """Interleave three 10-bit coordinates into one 30-bit Morton code."""
    return _part1by2(x) | (_part1by2(y) << 1) | (_part1by2(z) << 2)


def morton3d_decode(code):
    code = jnp.asarray(code, jnp.uint32)
    return _compact1by2(code), _compact1by2(code >> 1), _compact1by2(code >> 2)
