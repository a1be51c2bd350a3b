"""SBELL — striped block-ELL, the unstructured-SpMV layout.

Layout (row-slice tiles over 8x8 blocks):
  * stripes of 128 block-rows (1024 scalar rows). Each block-row's
    blocks are sorted by column; SLICE k of a stripe collects the k-th
    block of every block-row — so tile slot i IS local block-row i and
    a tile's partial products land directly in output layout.
  * a tile is one (64, 128) value plane V[8j+i, slot] = block_slot[i, j]
    plus one (128,) int32 meta row (col_local, 9 bits). Values stream
    coalesced: row 8j+i of the plane is 128 consecutive words.
  * tile slots gather x from a window of <= W_PANES consecutive
    128-block-col x *panes*: a tile's block column is
    pane * 128 + meta[slot]. Banded/FEM matrices keep the window
    property per slice because 128 consecutive block-rows span
    ~band-width consecutive block-cols, so the 128 gathered x entries
    of one tile row are near-contiguous in the pane layout.
  * tiles are stripe-major; tptr[s]:tptr[s+1] is stripe s's tile range
    (a CSR pointer over stripes), so a kernel program can own a stripe
    and walk its tiles with no scatter.
  * blocks outside their slice's pane window, slices thinner than
    MIN_OCCUPANCY rows, and blocks past K_CAP slices: routed to the
    FAR set — a flat block-COO applied as one gather + one scatter-add
    per far block, proportional to n_far only.

Capability parity: the re-expression of the reference's hierarchical
sparse-grid + dense-leaf storage (lib/sparse/include/DenseBlock.hpp,
PointerBlock.hpp) applied to matrix storage, per BASELINE.json configs[1]
(SuiteSparse cant/pwtk, 8x8 blocks).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

B = 8              # scalar block size (8x8 blocks)
LANE = 128         # slots per tile = local block-rows per stripe
STRIPE_ROWS = B * LANE      # 1024 scalar rows per stripe
PANE_COLS = B * LANE        # 1024 scalar cols per x pane
VROWS = B * B      # 64 value rows per tile (meta rides separately)
W_PANES = 3        # x panes a tile may span: a slice of 128 consecutive
                   # block-rows spans ~128+band block-cols, which can
                   # straddle two pane boundaries
# a near tile streams a full 64x128 value plane whatever its occupancy,
# so slices below ~8 blocks are cheaper as individual far blocks
MIN_OCCUPANCY = 8   # slices thinner than this dissolve into the far set
K_CAP = 32          # max slices per stripe; deeper rows spill to far


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FarBlocks:
    """Flat block-COO far set: one entry per stored 8x8 block.

    SpMV work is exactly one x row-gather per block plus one scatter-add
    of the per-entry partial rows (duplicate block-rows allowed) — both
    proportional to n_far, never to the matrix row count."""

    rows: jax.Array    # (nf,) i32 block-row ids (duplicates allowed)
    cols: jax.Array    # (nf,) i32 block-col ids
    blocks: jax.Array  # (nf, B, B) f32 (or bf16 for the bf16 variant)
    shape: tuple = dataclasses.field(metadata=dict(static=True))

    @property
    def n_far(self) -> int:
        return self.rows.shape[0]

    @property
    def nnz_stored(self) -> int:
        return self.n_far * B * B

    @property
    def hbm_bytes(self) -> int:
        """Per-SpMV traffic: blocks + 2 index streams + gathered x rows +
        read-modify-write of the touched y rows."""
        bsize = jnp.dtype(self.blocks.dtype).itemsize
        return (self.blocks.size * bsize + self.rows.size * 8
                + self.n_far * B * 4 + 3 * self.n_far * B * 4)


def tile_pointer(sid: np.ndarray, n_guarded: int) -> np.ndarray:
    """(n_guarded + 1,) i32 stripe -> tile-range pointer of a stripe-major
    tile stream: stripe s owns tiles [ptr[s], ptr[s+1])."""
    return np.searchsorted(np.asarray(sid), np.arange(n_guarded + 1),
                           side="left").astype(np.int32)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SBELL:
    """Striped block-ELL matrix (see module docstring for the layout).

    Padding tiles (zero values) carry the first guard stripe's id, so
    `sid` stays sorted and every consumer treats them as inert."""

    vflat: jax.Array   # (n_tiles*VROWS, 128) f32/bf16 value planes
    meta: jax.Array    # (n_tiles, 128) i32 col_local per slot
    pane: jax.Array    # (n_tiles,) i32 base x-pane per tile
    sid: jax.Array     # (n_tiles,) i32 stripe id per tile (sorted)
    tptr: jax.Array    # (n_stripes + W_PANES,) i32 stripe tile pointer
    far: object        # FarBlocks or None
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    n_stripes: int = dataclasses.field(metadata=dict(static=True))
    n_panes: int = dataclasses.field(metadata=dict(static=True))

    @property
    def n_tiles(self) -> int:
        return self.vflat.shape[0] // VROWS

    @property
    def n_guarded(self) -> int:
        """Stripes of the guarded output layout (W_PANES - 1 zero guard
        stripes ride after the real ones)."""
        return self.n_stripes + W_PANES - 1

    @property
    def nnz_stored(self) -> int:
        """Stored scalar slots (64 per block slot, incl. padding)."""
        far = self.far.nnz_stored if self.far is not None else 0
        return self.n_tiles * LANE * B * B + far

    @property
    def hbm_bytes(self) -> int:
        """Bytes streamed per SpMV: near value+meta planes + per-tile
        scalars + the far set's own traffic + x + y. The value-plane term
        uses the actual stored itemsize (2 for the bf16 variant)."""
        far = self.far.hbm_bytes if self.far is not None else 0
        vsize = jnp.dtype(self.vflat.dtype).itemsize
        return (self.vflat.size * vsize + self.meta.size * 4
                + self.pane.size * 4 + self.tptr.size * 4
                + self.n_panes * PANE_COLS * 4
                + self.n_stripes * STRIPE_ROWS * 4
                + far)

    def astype_values(self, dtype) -> "SBELL":
        """Value-stream precision variant: cast the stored values — 80%+
        of hbm_bytes on cant/pwtk — to `dtype` (bf16 halves the dominant
        HBM stream; the matvec still accumulates in f32, so the result
        equals the bf16-QUANTIZED operator applied in f32: error vs the
        f32 operator is bounded by bf16's 2^-8 relative value rounding).
        Far blocks are cast too so the quantization is uniform."""
        far = self.far
        if far is not None:
            far = dataclasses.replace(far, blocks=far.blocks.astype(dtype))
        return dataclasses.replace(
            self, vflat=self.vflat.astype(dtype), far=far)

    def fill_ratio(self, nnz: int) -> float:
        return self.nnz_stored / max(nnz, 1)

    @property
    def far_fraction(self) -> float:
        """Fraction of stored blocks routed to the far (row-gather) path."""
        if self.far is None:
            return 0.0
        return self.far.n_far / max(self.far.n_far + self.n_tiles * LANE, 1)

    @staticmethod
    def from_scipy(A) -> "SBELL":
        """Host-side construction from any scipy.sparse matrix."""
        import scipy.sparse as sps

        A = sps.csr_matrix(A)
        m, n = A.shape
        n_stripes = -(-m // STRIPE_ROWS)
        n_panes = -(-n // PANE_COLS)
        mp, np_ = n_stripes * STRIPE_ROWS, n_panes * PANE_COLS
        if (mp, np_) != (m, n):
            A = sps.csr_matrix((A.data, A.indices, A.indptr), shape=(m, np_))
            A.resize((mp, np_))
        bsr = A.tobsr((B, B))
        blocks = np.ascontiguousarray(bsr.data, dtype=np.float32)
        bcols = bsr.indices.astype(np.int64)
        indptr = bsr.indptr.astype(np.int64)

        tiles = []                 # (v (64,128), meta (128,), pane, sid)
        far_br, far_bc, far_blk = [], [], []

        def to_far(rows_g, cols, blks):
            far_br.append(rows_g)
            far_bc.append(cols)
            far_blk.append(blks)

        for s in range(n_stripes):
            r0, r1 = s * LANE, (s + 1) * LANE
            lo, hi = indptr[r0], indptr[r1]
            if lo == hi:
                continue
            counts = np.diff(indptr[r0:r1 + 1])
            K = int(counts.max())
            brl = np.repeat(np.arange(LANE, dtype=np.int64), counts)
            bc = bcols[lo:hi]
            blk = blocks[lo:hi]
            # per block-row, blocks sorted by column (CSR/BSR guarantee):
            # slice k = the k-th block of every row that has one
            kpos = np.arange(hi - lo, dtype=np.int64) \
                - np.repeat(indptr[r0:r1] - lo, counts)
            for k in range(K):
                sel = kpos == k
                rows_k = brl[sel]
                cols_k = bc[sel]
                blks_k = blk[sel]
                if k >= K_CAP or len(rows_k) < MIN_OCCUPANCY:
                    to_far(s * LANE + rows_k, cols_k, blks_k)
                    continue
                # pane window: pick the base covering the most blocks
                panes = cols_k >> 7
                cands = (int(panes.min()), max(int(panes.max()) - W_PANES
                                               + 1, 0))
                best, best_in = cands[0], -1
                for p in set(cands):
                    nin = int(((panes >= p)
                               & (panes < p + W_PANES)).sum())
                    if nin > best_in:
                        best, best_in = p, nin
                inw = (panes >= best) & (panes < best + W_PANES)
                if (~inw).any():
                    to_far(s * LANE + rows_k[~inw], cols_k[~inw],
                           blks_k[~inw])
                    rows_k, cols_k, blks_k = (rows_k[inw], cols_k[inw],
                                              blks_k[inw])
                if len(rows_k) < MIN_OCCUPANCY:
                    to_far(s * LANE + rows_k, cols_k, blks_k)
                    continue
                v = np.zeros((B * B, LANE), np.float32)
                # V[8j+i, slot=local block-row] = block[i, j]
                v[:, rows_k] = blks_k.transpose(2, 1, 0).reshape(B * B, -1)
                meta = np.zeros(LANE, np.int32)
                meta[rows_k] = (cols_k - (best << 7)).astype(np.int32)
                tiles.append((v, meta, best, s))

        # an operator with no near tile keeps one inert padding tile so
        # every array has a nonzero extent
        n_tiles = max(len(tiles), 1)
        vflat = np.zeros((n_tiles, VROWS, LANE), np.float32)
        metas = np.zeros((n_tiles, LANE), np.int32)
        pane = np.zeros(n_tiles, np.int32)
        sid = np.full(n_tiles, n_stripes, np.int32)
        for t, (v, meta, p, s) in enumerate(tiles):
            vflat[t] = v
            metas[t] = meta
            pane[t], sid[t] = p, s

        far = None
        if far_br:
            far = FarBlocks(
                rows=jnp.asarray(np.concatenate(far_br).astype(np.int32)),
                cols=jnp.asarray(np.concatenate(far_bc).astype(np.int32)),
                blocks=jnp.asarray(np.concatenate(far_blk,
                                                  dtype=np.float32)),
                shape=(mp, np_))

        return SBELL(
            vflat=jnp.asarray(vflat.reshape(n_tiles * VROWS, LANE)),
            meta=jnp.asarray(metas),
            pane=jnp.asarray(pane),
            sid=jnp.asarray(sid),
            tptr=jnp.asarray(tile_pointer(sid, n_stripes + W_PANES - 1)),
            far=far,
            shape=(m, n),
            n_stripes=n_stripes,
            n_panes=n_panes,
        )
