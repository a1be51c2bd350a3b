"""Dense N-D containers: HaloArray (ghost-cell array).

Re-expression of the reference's HPCHighDimensionFlatArray
(lib/hpc/include/HPCHighDimensionFlatArray.hpp:54-57,107-123,151-171):
a flat N-D array with per-dimension Low/High ghost-cell bounds, where
negative indices address the halo. Here the padded storage is one jax
array (XLA insists on static shapes anyway — the same trade the reference
makes with compile-time Low_Bound/High_Bound template parameters), and the
two reference access paths map to:

  * `operator()` unchecked negative-index reads  -> `shift()` /
    `window()` whole-array views (vectorized: the idiomatic unit of
    access is the shifted interior view a stencil consumes, not a
    scalar);
  * `at()` checked access (ref :107-123)          -> bounds are validated
    in Python at trace time (shapes/offsets are static), raising
    IndexError before any device code is built.

One definition of "ghost cells" serves both execution modes:
  * single chip: `HaloArray.wrap(x, lo, hi)` zero-fills the halo
    (Dirichlet) — ops/stencil.py;
  * distributed: the halo slots are refreshed from mesh neighbors via
    `ppermute` — parallel/halo.py:refresh_halo — and the same stencil
    kernels run on the result (parallel/dist_stencil.py).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp


def _normalize(ndim: int, v) -> tuple:
    if isinstance(v, int):
        return (v,) * ndim
    v = tuple(int(x) for x in v)
    if len(v) != ndim:
        raise ValueError(f"halo spec {v} does not match ndim {ndim}")
    return v


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HaloArray:
    """N-D array with per-dim (low, high) ghost cells.

    data: padded storage, shape[d] = lo[d] + interior[d] + hi[d]
    lo/hi: static per-dim halo widths
    """

    data: jax.Array
    lo: tuple = dataclasses.field(metadata=dict(static=True))
    hi: tuple = dataclasses.field(metadata=dict(static=True))

    # ---- construction -----------------------------------------------------

    @staticmethod
    def wrap(interior: jax.Array, lo, hi=None, fill=0) -> "HaloArray":
        """Surround `interior` with constant-filled ghost cells."""
        nd = interior.ndim
        lo = _normalize(nd, lo)
        hi = _normalize(nd, lo if hi is None else hi)
        pad = tuple((l, h) for l, h in zip(lo, hi))
        data = jnp.pad(interior, pad, constant_values=fill)
        return HaloArray(data=data, lo=lo, hi=hi)

    @staticmethod
    def from_padded(data: jax.Array, lo, hi=None) -> "HaloArray":
        """Adopt an already-padded array (e.g. assembled from ppermute)."""
        nd = data.ndim
        lo = _normalize(nd, lo)
        hi = _normalize(nd, lo if hi is None else hi)
        return HaloArray(data=data, lo=lo, hi=hi)

    # ---- geometry -----------------------------------------------------------

    @property
    def ndim(self) -> int:
        return self.data.ndim

    @property
    def interior_shape(self) -> tuple:
        return tuple(s - l - h
                     for s, l, h in zip(self.data.shape, self.lo, self.hi))

    @property
    def interior(self) -> jax.Array:
        return self.window((0,) * self.ndim, self.interior_shape)

    # ---- access -------------------------------------------------------------

    def window(self, starts, shape) -> jax.Array:
        """Interior-relative rectangular view; negative starts address the
        halo (the reference's negative-index `operator()`, vectorized).
        Bounds are checked at trace time like its `at()` (:107-123)."""
        starts = _normalize(self.ndim, tuple(starts))
        shape = tuple(int(s) for s in shape)
        idx = []
        for d, (s, n) in enumerate(zip(starts, shape)):
            a = self.lo[d] + s
            if a < 0 or a + n > self.data.shape[d]:
                raise IndexError(
                    f"window dim {d}: [{s}, {s + n}) exceeds halo bounds "
                    f"[-{self.lo[d]}, {self.interior_shape[d] + self.hi[d]})")
            idx.append(slice(a, a + n))
        return self.data[tuple(idx)]

    def shift(self, offsets) -> jax.Array:
        """Interior-shaped view displaced by `offsets` — the stencil access
        primitive: shift((-1, 0)) is the reference's a(y-1, x)."""
        return self.window(offsets, self.interior_shape)

    # ---- update -------------------------------------------------------------

    def with_interior(self, interior: jax.Array) -> "HaloArray":
        """Replace the interior, keeping current ghost values."""
        if tuple(interior.shape) != self.interior_shape:
            raise ValueError(
                f"interior shape {interior.shape} != {self.interior_shape}")
        idx = tuple(slice(l, l + n)
                    for l, n in zip(self.lo, self.interior_shape))
        return HaloArray(data=self.data.at[idx].set(interior),
                         lo=self.lo, hi=self.hi)

    def set_halo(self, dim: int, side: str, values: jax.Array) -> "HaloArray":
        """Overwrite one halo slab ('lo' or 'hi' of `dim`) — the write half
        of a halo exchange; parallel/halo.py feeds it ppermute results."""
        w = self.lo[dim] if side == "lo" else self.hi[dim]
        if w == 0:
            return self
        sl = [slice(None)] * self.ndim
        sl[dim] = slice(0, w) if side == "lo" \
            else slice(self.data.shape[dim] - w, self.data.shape[dim])
        return HaloArray(data=self.data.at[tuple(sl)].set(values),
                         lo=self.lo, hi=self.hi)
