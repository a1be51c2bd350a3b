"""Compensated (double-float) reductions — f64-class accuracy from f32
arithmetic.

The library computes in f32; long CG/residual chains on large systems can
lose 3-4 digits to f32 cancellation. These routines carry each value as an
unevaluated (hi, lo) pair using the classic error-free transformations:

  two_sum   — Knuth's branch-free exact addition error
  two_prod  — Dekker/Veltkamp split product error (no FMA dependency)
  df_*      — double-float arithmetic on (hi, lo) pairs
  sum_compensated / dot_compensated — log2(n)-pass vectorized tree
      reductions in double-float (every pass is a dense elementwise op; no serial
      Kahan loop)

Accuracy: ~2×24-bit significand ≈ f64 for n ≤ 1e8-class reductions.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_SPLIT = jnp.float32((1 << 12) + 1)  # Veltkamp splitter for f32 (24-bit)


def two_sum(a, b):
    """s + e == a + b exactly (|e| ≤ ulp(s)/2)."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def _split(a):
    c = _SPLIT * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """p + e == a * b exactly (Dekker, splitter-based)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(xh, xl, yh, yl):
    """(xh, xl) + (yh, yl) in double-float."""
    s, e = two_sum(xh, yh)
    e = e + (xl + yl)
    hi, lo = two_sum(s, e)
    return hi, lo


def _tree_reduce_df(hi, lo):
    """Pairwise double-float tree reduction: log2(n) vectorized passes."""
    n = hi.shape[0]
    while n > 1:
        if n % 2:
            hi = jnp.concatenate([hi, jnp.zeros((1,), hi.dtype)])
            lo = jnp.concatenate([lo, jnp.zeros((1,), lo.dtype)])
            n += 1
        hi, lo = df_add(hi[0::2], lo[0::2], hi[1::2], lo[1::2])
        n //= 2
    return hi[0], lo[0]


@jax.jit
def sum_compensated(x):
    """Σx with double-float accuracy; returns f32 (hi + lo)."""
    x = x.reshape(-1).astype(jnp.float32)
    hi, lo = _tree_reduce_df(x, jnp.zeros_like(x))
    return hi + lo


@jax.jit
def dot_compensated(x, y):
    """<x, y> with error-free products + double-float accumulation."""
    x = x.reshape(-1).astype(jnp.float32)
    y = y.reshape(-1).astype(jnp.float32)
    p, e = two_prod(x, y)
    hi, lo = _tree_reduce_df(p, e)
    return hi + lo


@jax.jit
def norm2_compensated(x):
    return jnp.sqrt(dot_compensated(x, x))
