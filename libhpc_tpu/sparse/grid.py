"""Hierarchical sparse block grid — a batched JAX re-expression of the
reference's lib/sparse stack (RootGrid / PointerBlock / HashBlock /
DenseBlock, lib/sparse/include/RootGrid.hpp:12, SparseDS.hpp:4-7).

The reference allocates dense leaf tiles on first touch behind CAS/hash
inserts (PointerBlock.hpp:100-125, HashBlock.hpp:92-102). Batched JAX
has no per-thread atomics and no pointers; the same capabilities become:

  tile_map (Gy, Gx) int32   — the 'pointer block': slot id or -1 (= null)
  tiles (capacity, B, B)    — the pool of dense leaf blocks ('DenseBlock's)
  n_active                  — bump 'allocator' cursor (XLA-donated update)

and the mutation API is *batched*: `touch_batch` replaces per-element
insert-on-touch with sort-dedupe-allocate (the radix-binning descendant,
SURVEY.md §3.3), `write_batch` replaces CAS scatter with one XLA
scatter-add. All methods are jitted and static-shape; capacity is the
compile-time bound (like the reference's GridSize template parameter).

Coordinates: x is the fast (column) axis, matching the reference's
``write(x, y, v)`` convention (RootGrid.hpp:17).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BlockGrid:
    tile_map: jax.Array   # (Gy, Gx) int32, -1 = unallocated
    tile_pos: jax.Array   # (capacity,) int32: slot -> tile raster id (-1)
    tiles: jax.Array      # (capacity, B, B)
    n_active: jax.Array   # () int32
    block_size: int = dataclasses.field(metadata=dict(static=True))
    capacity: int = dataclasses.field(metadata=dict(static=True))

    # -- construction ------------------------------------------------------

    @staticmethod
    def create(grid_blocks: tuple, block_size: int = 16,
               capacity: int = 1024, dtype=jnp.float32) -> "BlockGrid":
        gy, gx = grid_blocks
        return BlockGrid(
            tile_map=jnp.full((gy, gx), -1, jnp.int32),
            tile_pos=jnp.full((capacity,), -1, jnp.int32),
            tiles=jnp.zeros((capacity, block_size, block_size), dtype),
            n_active=jnp.zeros((), jnp.int32),
            block_size=block_size,
            capacity=capacity,
        )

    @property
    def shape(self) -> tuple:
        """Element-level extent (y, x)."""
        gy, gx = self.tile_map.shape
        return (gy * self.block_size, gx * self.block_size)

    def _split(self, xs, ys):
        b = self.block_size
        return xs // b, ys // b, xs % b, ys % b

    # -- touch (allocation) ------------------------------------------------

    @partial(jax.jit, static_argnames=("order",))
    def touch_batch(self, xs, ys, order: str = "raster") -> "BlockGrid":
        """Allocate leaf tiles for every (x, y) — batched insert-on-touch.

        Dedupe via sort + head-flags (no hash map needed), then assign pool
        slots in order. Already-allocated tiles keep their slot (idempotent,
        like the reference's DCLP touch_pointer, PointerBlock.hpp:100-125).
        """
        bx, by, _, _ = self._split(xs.astype(jnp.int32), ys.astype(jnp.int32))
        gy, gx = self.tile_map.shape
        if order == "morton":
            # Z-order slot assignment: spatially adjacent tiles get nearby
            # pool slots (the reference's libmorton layout trick applied to
            # the tile pool). The Morton code is a bijection of (bx, by),
            # so it serves directly as the unique tile id.
            from libhpc_tpu.utils.morton import morton2d_encode

            tid = morton2d_encode(bx.astype(jnp.uint32),
                                  by.astype(jnp.uint32))
        else:
            tid = (by * gx + bx).astype(jnp.uint32)    # flat tile ids
        tid_sorted = jax.lax.sort(tid)
        is_head = jnp.concatenate(
            [jnp.ones((1,), bool), tid_sorted[1:] != tid_sorted[:-1]]
        )
        # unique tile ids packed to the front (tail padded with duplicates)
        head_order = jnp.argsort(~is_head, stable=True)
        uniq = tid_sorted[head_order]                  # heads first
        n_uniq = jnp.sum(is_head.astype(jnp.int32))
        k = jnp.arange(tid.shape[0])
        if order == "morton":
            from libhpc_tpu.utils.morton import morton2d_decode

            ux32, uy32 = morton2d_decode(uniq)
            ux, uy = ux32.astype(jnp.int32), uy32.astype(jnp.int32)
        else:
            uniq_i = uniq.astype(jnp.int32)
            uy, ux = uniq_i // gx, uniq_i % gx
        existing = self.tile_map[uy, ux]
        is_new = (existing < 0) & (k < n_uniq)
        # slot for each new tile: n_active + rank among new
        new_rank = jnp.cumsum(is_new.astype(jnp.int32)) - is_new
        slot = jnp.where(is_new, self.n_active + new_rank, existing)
        # out-of-capacity tiles stay unallocated (fail-soft; checkable)
        slot = jnp.where(slot < self.capacity, slot, existing)
        do_write = is_new & (slot >= 0)
        tm = self.tile_map.at[
            jnp.where(do_write, uy, 0), jnp.where(do_write, ux, 0)
        ].max(jnp.where(do_write, slot.astype(jnp.int32), -1))
        # inverse map slot -> tile raster id (consumed by the dense-staging
        # write path's pull-gather); dropped writes for non-allocations
        tp = self.tile_pos.at[
            jnp.where(do_write, slot.astype(jnp.int32),
                      jnp.int32(self.capacity))
        ].set((uy * gx + ux).astype(jnp.int32), mode="drop")
        n_new = jnp.minimum(
            self.n_active + jnp.sum(is_new.astype(jnp.int32)),
            jnp.int32(self.capacity),
        )
        return dataclasses.replace(self, tile_map=tm, tile_pos=tp,
                                   n_active=n_new)

    # -- read / write ------------------------------------------------------

    @partial(jax.jit, static_argnames=("mode",))
    def write_batch(self, xs, ys, vals, mode: str = "add") -> "BlockGrid":
        """Batched write into touched tiles — the particle-write workload
        (test_hpc_benchmark.cpp:866-870: 2^20 writes per iteration).

        Writes to untouched tiles are dropped (slot -1 → out-of-range
        scatter index, which XLA drops) — mirroring that the reference
        would have touched first.
        """
        bx, by, ox, oy = self._split(xs.astype(jnp.int32), ys.astype(jnp.int32))
        slot = self.tile_map[by, bx]
        b = self.block_size
        # linearized destination: flat 1D scatter (one fused index
        # computation instead of three scatter dims)
        lin = slot * (b * b) + oy * b + ox
        n_lin = self.capacity * b * b
        lin_safe = jnp.where(slot >= 0, lin, n_lin)  # OOB → dropped
        flat = self.tiles.reshape(n_lin)
        if mode == "add":
            flat = flat.at[lin_safe].add(vals, mode="drop")
        elif mode == "set":
            flat = flat.at[lin_safe].set(vals, mode="drop")
        else:
            raise ValueError(mode)
        return dataclasses.replace(
            self, tiles=flat.reshape(self.tiles.shape))

    @jax.jit
    def write_batch_dense(self, xs, ys, vals) -> "BlockGrid":
        """Accumulating batched write via a dense staging image — the fast
        path for large random write bursts (the particle workload,
        test_hpc_benchmark.cpp:866-870).

        `write_batch` pays a per-element tile_map gather *plus* the pool
        scatter. Here writes scatter straight into a
        dense (Gy·B, Gx·B) zero image by raster coordinate (pure arithmetic
        indexing, no gather), and the image is folded into the tile pool with
        one per-tile row-gather through the slot->tile inverse map (B²-sized
        rows amortize the gather: ~0.5 ms for 64k tiles). Writes landing in
        untouched tiles are dropped, matching `write_batch`.

        Costs O(shape) staging memory — intended for grids whose dense image
        fits HBM comfortably; `write_batch` remains the frugal path. Add-mode
        only (set-mode with duplicate destinations is order-defined and must
        go through the scatter path).
        """
        xs, ys = xs.astype(jnp.int32), ys.astype(jnp.int32)
        gy, gx = self.tile_map.shape
        b = self.block_size
        w = gx * b
        dense = jnp.zeros((gy * b * w,), self.tiles.dtype)
        dense = dense.at[ys * w + xs].add(vals, mode="drop")
        # (Gy·B, Gx·B) -> (Gy·Gx, B, B) tile view, then pull active slots
        dense4 = dense.reshape(gy, b, gx, b).transpose(0, 2, 1, 3)
        dense4 = dense4.reshape(gy * gx, b, b)
        delta = dense4[jnp.clip(self.tile_pos, 0, None)]
        active = (jnp.arange(self.capacity) < self.n_active)[:, None, None]
        return dataclasses.replace(
            self, tiles=jnp.where(active, self.tiles + delta, self.tiles))

    @jax.jit
    def read_batch(self, xs, ys):
        """Batched read; unallocated tiles read as 0 (the reference returns
        default T{} for null blocks, RootGrid.hpp:25-45)."""
        bx, by, ox, oy = self._split(xs.astype(jnp.int32), ys.astype(jnp.int32))
        slot = self.tile_map[by, bx]
        b = self.block_size
        lin = jnp.clip(slot, 0, self.capacity - 1) * (b * b) + oy * b + ox
        vals = self.tiles.reshape(-1)[lin]  # flat 1D gather (see write_batch)
        return jnp.where(slot >= 0, vals, 0)

    # -- foreach / todense -------------------------------------------------

    @partial(jax.jit, static_argnames=("fn",))
    def map_tiles(self, fn) -> "BlockGrid":
        """Apply fn: (B, B) -> (B, B) over all *active* tiles (the
        reference's foreach, DenseBlock.hpp:63-70). Inactive pool slots are
        left untouched."""
        active = jnp.arange(self.capacity) < self.n_active
        new_tiles = jax.vmap(fn)(self.tiles)
        tiles = jnp.where(active[:, None, None], new_tiles, self.tiles)
        return dataclasses.replace(self, tiles=tiles)

    @jax.jit
    def todense(self) -> jax.Array:
        gy, gx = self.tile_map.shape
        b = self.block_size
        slot = self.tile_map  # (gy, gx)
        vals = self.tiles[jnp.clip(slot, 0, self.capacity - 1)]  # (gy,gx,b,b)
        vals = jnp.where((slot >= 0)[:, :, None, None], vals, 0)
        return vals.transpose(0, 2, 1, 3).reshape(gy * b, gx * b)

    @jax.jit
    def n_allocated(self):
        return self.n_active


# ---------------------------------------------------------------------------
# generic batched slot allocator (shared by nested grids)
# ---------------------------------------------------------------------------


def _alloc_slots(flat_map, keys, n_active, capacity: int):
    """Batched dedupe-allocate over a flat int32 slot map (-1 = empty).

    keys: uint32; 0xFFFFFFFF is the 'invalid' sentinel (dropped). For each
    unique valid key, keep the existing slot or assign the next pool slot;
    fail-soft past capacity. The batched replacement for the reference's
    per-element DCLP CAS / hash-insert allocation
    (PointerBlock.hpp:100-125, HashBlock.hpp:92-102)."""
    SENT = jnp.uint32(0xFFFFFFFF)
    ks = jax.lax.sort(keys)
    is_head = jnp.concatenate([jnp.ones((1,), bool), ks[1:] != ks[:-1]])
    head_order = jnp.argsort(~is_head, stable=True)
    uniq = ks[head_order]                      # unique keys packed first
    n_uniq = jnp.sum(is_head.astype(jnp.int32))
    k = jnp.arange(keys.shape[0])
    valid = uniq != SENT
    uniq_i = jnp.where(valid, uniq, 0).astype(jnp.int32)
    existing = flat_map[uniq_i]
    is_new = valid & (existing < 0) & (k < n_uniq)
    new_rank = jnp.cumsum(is_new.astype(jnp.int32)) - is_new
    slot = jnp.where(is_new, n_active + new_rank, existing)
    slot = jnp.where(slot < capacity, slot, existing)  # fail-soft
    do_write = is_new & (slot >= 0)
    fm = flat_map.at[jnp.where(do_write, uniq_i, 0)].max(
        jnp.where(do_write, slot.astype(jnp.int32), -1))
    n_new = jnp.minimum(
        n_active + jnp.sum(is_new.astype(jnp.int32)), jnp.int32(capacity))
    return fm, n_new


# ---------------------------------------------------------------------------
# 3-level nested grid (pointer -> mid -> dense leaf parity)
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NestedGrid:
    """Three-level sparse grid — full structural parity with the reference's
    composed layout stacks, e.g. PointerBlock<N, HashBlock<DenseBlock<B>>>
    (RootGrid.hpp:12 + SparseDS.hpp:4-7, composed in
    test_hpc_benchmark.cpp:861-909):

      map0 (G0y, G0x) int32        — top pointer grid: mid slot or -1
      mid_maps (cap_mid, G1y, G1x) — per-mid pointer grids: leaf slot or -1
      leaves (cap_leaf, B, B)      — dense leaf pool

    Element (x, y) resolves through two indirections; all mutation is
    batched sort-dedupe-allocate (no atomics needed)."""

    map0: jax.Array
    mid_maps: jax.Array
    leaves: jax.Array
    n_mid: jax.Array
    n_leaf: jax.Array
    block_size: int = dataclasses.field(metadata=dict(static=True))
    mid_grid: tuple = dataclasses.field(metadata=dict(static=True))
    cap_mid: int = dataclasses.field(metadata=dict(static=True))
    cap_leaf: int = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def create(grid0: tuple, mid_grid: tuple = (8, 8), block_size: int = 16,
               cap_mid: int = 64, cap_leaf: int = 1024,
               dtype=jnp.float32) -> "NestedGrid":
        g0y, g0x = grid0
        g1y, g1x = mid_grid
        return NestedGrid(
            map0=jnp.full((g0y, g0x), -1, jnp.int32),
            mid_maps=jnp.full((cap_mid, g1y, g1x), -1, jnp.int32),
            leaves=jnp.zeros((cap_leaf, block_size, block_size), dtype),
            n_mid=jnp.zeros((), jnp.int32),
            n_leaf=jnp.zeros((), jnp.int32),
            block_size=block_size,
            mid_grid=(g1y, g1x),
            cap_mid=cap_mid,
            cap_leaf=cap_leaf,
        )

    @property
    def shape(self) -> tuple:
        g0y, g0x = self.map0.shape
        g1y, g1x = self.mid_grid
        b = self.block_size
        return (g0y * g1y * b, g0x * g1x * b)

    def _split(self, xs, ys):
        b = self.block_size
        g1y, g1x = self.mid_grid
        ox, oy = xs % b, ys % b
        tx, ty = xs // b, ys // b
        bx1, by1 = tx % g1x, ty % g1y
        bx0, by0 = tx // g1x, ty // g1y
        return bx0, by0, bx1, by1, ox, oy

    @jax.jit
    def touch_batch(self, xs, ys) -> "NestedGrid":
        xs, ys = xs.astype(jnp.int32), ys.astype(jnp.int32)
        bx0, by0, bx1, by1, _, _ = self._split(xs, ys)
        g0y, g0x = self.map0.shape
        g1y, g1x = self.mid_grid
        # level 0: allocate mid blocks
        key0 = (by0 * g0x + bx0).astype(jnp.uint32)
        m0, n_mid = _alloc_slots(self.map0.reshape(-1), key0, self.n_mid,
                                 self.cap_mid)
        slot0 = m0[by0 * g0x + bx0]
        # level 1: allocate leaves within each allocated mid block
        key1 = slot0 * (g1y * g1x) + by1 * g1x + bx1
        key1 = jnp.where(slot0 >= 0, key1.astype(jnp.uint32),
                         jnp.uint32(0xFFFFFFFF))
        m1, n_leaf = _alloc_slots(self.mid_maps.reshape(-1), key1,
                                  self.n_leaf, self.cap_leaf)
        return dataclasses.replace(
            self, map0=m0.reshape(g0y, g0x),
            mid_maps=m1.reshape(self.mid_maps.shape),
            n_mid=n_mid, n_leaf=n_leaf)

    def _leaf_lin(self, xs, ys):
        """Linear leaf-pool index per element; < 0 where unallocated."""
        bx0, by0, bx1, by1, ox, oy = self._split(xs, ys)
        g0y, g0x = self.map0.shape
        g1y, g1x = self.mid_grid
        b = self.block_size
        slot0 = self.map0[by0, bx0]
        mid_idx = (jnp.clip(slot0, 0, self.cap_mid - 1) * (g1y * g1x)
                   + by1 * g1x + bx1)
        slot1 = self.mid_maps.reshape(-1)[mid_idx]
        slot1 = jnp.where(slot0 >= 0, slot1, -1)
        lin = slot1 * (b * b) + oy * b + ox
        return jnp.where(slot1 >= 0, lin, -1)

    @partial(jax.jit, static_argnames=("mode",))
    def write_batch(self, xs, ys, vals, mode: str = "add") -> "NestedGrid":
        xs, ys = xs.astype(jnp.int32), ys.astype(jnp.int32)
        lin = self._leaf_lin(xs, ys)
        b = self.block_size
        n_lin = self.cap_leaf * b * b
        lin_safe = jnp.where(lin >= 0, lin, n_lin)  # OOB -> dropped
        flat = self.leaves.reshape(n_lin)
        if mode == "add":
            flat = flat.at[lin_safe].add(vals, mode="drop")
        elif mode == "set":
            flat = flat.at[lin_safe].set(vals, mode="drop")
        else:
            raise ValueError(mode)
        return dataclasses.replace(
            self, leaves=flat.reshape(self.leaves.shape))

    @jax.jit
    def read_batch(self, xs, ys):
        xs, ys = xs.astype(jnp.int32), ys.astype(jnp.int32)
        lin = self._leaf_lin(xs, ys)
        vals = self.leaves.reshape(-1)[jnp.clip(lin, 0, None)]
        return jnp.where(lin >= 0, vals, 0)

    @partial(jax.jit, static_argnames=("fn",))
    def map_leaves(self, fn) -> "NestedGrid":
        """fn: (B, B) -> (B, B) over active leaves (the reference's foreach
        recursion, RootGrid.hpp:62-75)."""
        active = jnp.arange(self.cap_leaf) < self.n_leaf
        new = jax.vmap(fn)(self.leaves)
        leaves = jnp.where(active[:, None, None], new, self.leaves)
        return dataclasses.replace(self, leaves=leaves)

    @jax.jit
    def todense(self) -> jax.Array:
        h, w = self.shape
        yy = jnp.arange(h, dtype=jnp.int32)
        xx = jnp.arange(w, dtype=jnp.int32)
        ygrid = jnp.repeat(yy, w)
        xgrid = jnp.tile(xx, h)
        return self.read_batch(xgrid, ygrid).reshape(h, w)
