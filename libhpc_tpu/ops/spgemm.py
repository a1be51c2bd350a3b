"""SpGEMM — sparse × sparse matrix multiply (BASELINE.json configs[4]).

SURVEY.md §7 hard-part #3: output-size-unknown computation in a static-shape
world. Same resolution as the reference's count→scan→scatter skeleton
(/root/reference/lib/sort/radix_cpu/include/radix_sort_cpu.hpp:254-322,
SURVEY.md §3.2) — two-pass algorithms:

  symbolic pass: expansion size S = Σ_{(i,k)∈A} nnz(B row k), computed
     exactly from the two indptr arrays (count → scan).
  numeric pass (jit): expand partial products into (row, col, val)
     triplets, then sort by (row, col) and segment-sum duplicates — the
     sort-and-merge formulation, which maps onto the device sort instead
     of per-element scatter.

Three numeric strategies, by scale:

  spgemm           ELL-of-B expansion, O(nnzA × kB) memory. Fast & simple
                   when B's max row length kB is moderate.
  spgemm_blocked   the same per row-block: O(block_nnz × kB).
  spgemm_windowed  EXACT expansion in fixed windows: O(window) device
                   memory regardless of kB or nnzA — the 100M-nnz-scale
                   path. Symbolic count→scan on the host,
                   then one identically-shaped jitted program per window
                   (compiled once): jnp.repeat forward-fill of the source
                   ids, piecewise-sequential B reads, 2-key sort, segment
                   merge, host-side compaction.

Output is COO (padded tails of explicit zeros where noted) — every
downstream op is additive so padding is harmless; `tocsr()` gives CSR.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from libhpc_tpu.sparse.coo import COO


def spgemm_expansion_size(A_csr, B_csr) -> int:
    """Symbolic pass: exact expanded-product count (host scalar)."""
    lenB = B_csr.row_lengths()
    return int(jnp.sum(lenB[A_csr.indices]))


@partial(jax.jit, static_argnames=("kB",))
def _spgemm_numeric(A, B_ell, kB: int):
    nnzA = A.nnz
    rowA = A.row_of_nnz()
    # expanded partial products: (nnzA, kB)
    vals = A.data[:, None] * B_ell.vals[A.indices]      # (nnzA, kB)
    cols = B_ell.cols[A.indices]                        # (nnzA, kB)
    rows = jnp.broadcast_to(rowA[:, None], (nnzA, kB))
    coo = COO(
        row=rows.reshape(-1).astype(jnp.int32),
        col=cols.reshape(-1).astype(jnp.int32),
        data=vals.reshape(-1),
        shape=(A.shape[0], B_ell.shape[1]),
    )
    return coo.sum_duplicates()


def spgemm(A_csr, B_csr):
    """C = A @ B as padded COO. Setup (ELL pack of B) is host-side."""
    if A_csr.shape[1] != B_csr.shape[0]:
        raise ValueError(f"shape mismatch {A_csr.shape} @ {B_csr.shape}")
    B_ell = B_csr.to_ell()
    return _spgemm_numeric(A_csr, B_ell, B_ell.k)


def spgemm_csr(A_csr, B_csr):
    """C = A @ B as padded CSR."""
    return spgemm(A_csr, B_csr).tocsr()


def spgemm_blocked(A_csr, B_csr, row_block: int = 4096):
    """Memory-bounded SpGEMM: process A in row blocks so the expansion
    buffer stays O(row_block_nnz × kB) instead of O(nnzA × kB) — required
    at the 100M-nnz scale (BASELINE configs[4]). Host loop over jitted
    per-block numeric passes; returns padded COO.
    """
    import numpy as np

    from libhpc_tpu.sparse.csr import CSR

    if A_csr.shape[1] != B_csr.shape[0]:
        raise ValueError(f"shape mismatch {A_csr.shape} @ {B_csr.shape}")
    B_ell = B_csr.to_ell()
    m = A_csr.shape[0]
    indptr_np = np.asarray(A_csr.indptr)
    rows_list, cols_list, data_list = [], [], []
    for r0 in range(0, m, row_block):
        r1 = min(m, r0 + row_block)
        p0, p1 = int(indptr_np[r0]), int(indptr_np[r1])
        if p1 == p0:
            continue
        blk = CSR(
            data=A_csr.data[p0:p1],
            indices=A_csr.indices[p0:p1],
            indptr=A_csr.indptr[r0 : r1 + 1] - p0,
            shape=(r1 - r0, A_csr.shape[1]),
        )
        c = _spgemm_numeric(blk, B_ell, B_ell.k)
        rows_list.append(c.row + r0)
        cols_list.append(c.col)
        data_list.append(c.data)
    if not rows_list:
        return COO(
            row=jnp.zeros((1,), jnp.int32), col=jnp.zeros((1,), jnp.int32),
            data=jnp.zeros((1,), A_csr.dtype),
            shape=(m, B_ell.shape[1]),
        )
    return COO(
        row=jnp.concatenate(rows_list).astype(jnp.int32),
        col=jnp.concatenate(cols_list).astype(jnp.int32),
        data=jnp.concatenate(data_list),
        shape=(m, B_ell.shape[1]),
    )


# ---------------------------------------------------------------------------
# windowed exact-expansion SpGEMM (the at-scale path)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("W", "SRC", "CBITS"))
def _spgemm_window(heads, drel, drow, dabits, n_valid,
                   B_indices, B_data, W: int, SRC: int, CBITS: int):
    """Numeric pass for one expansion window of W slots.

    Host-prepared per-source DELTA arrays (all length SRC; pad sources
    carry head slot W, which the scatters drop):
      heads   int32  window-local start slot of each source
      drel    int32  first-difference of (B start offset - global slot
                     start + w0) per source, so cumsum(ones scattered
                     with drel at heads) == the absolute B entry index
                     of every slot — piecewise-sequential B reads with
                     ZERO per-slot gathers
      drow    int32  first-difference of (source row - row_min)
      dabits  int32  first-difference of the A-value f32 BIT PATTERNS
                     (int32 wraparound arithmetic is exact, so the
                     cumsum reconstructs each source's f32 bits exactly)
    n_valid: scalar — live slots (tail of the last window is dead).

    Why deltas+cumsum: four per-slot table gathers (`x[src]`) plus a
    data-dependent `jnp.repeat` would dominate a window. Three SRC-sized
    scatters + three W-sized cumsums replace all of them; the only
    remaining per-slot gathers are the unavoidable B_indices/B_data
    reads. The (row, col) pair is PACKED into one positive int32 key
    ((row-row_min) << CBITS | col; expansion slots are row-contiguous so
    the relative row fits 31-CBITS bits, host-checked) — one packed kv
    lax.sort instead of the 3-operand 2-key sort.

    Returns (key, val, n_entries): sorted, deduped, zero-padded.
    """
    s = jnp.arange(W, dtype=jnp.int32)
    valid = s < n_valid
    idxB = jnp.cumsum(
        jnp.ones((W,), jnp.int32).at[heads].set(drel, mode="drop"))
    idxB = jnp.where(valid, idxB, 0)
    row_rel = jnp.cumsum(
        jnp.zeros((W,), jnp.int32).at[heads].set(drow, mode="drop"))
    abits = jnp.cumsum(
        jnp.zeros((W,), jnp.int32).at[heads].set(dabits, mode="drop"))
    aval = jax.lax.bitcast_convert_type(abits, jnp.float32)
    key = (row_rel << CBITS) | B_indices[idxB]
    key = jnp.where(valid, key, jnp.int32(2**31 - 1))
    val = jnp.where(valid, aval * B_data[idxB], 0)

    key, val = jax.lax.sort((key, val), num_keys=1)
    is_head = jnp.concatenate([valid[:1], key[1:] != key[:-1]])
    is_head = is_head & (jnp.arange(W) < n_valid)
    seg = jnp.cumsum(is_head.astype(jnp.int32)) - 1
    seg = jnp.where(seg < 0, 0, seg)
    data = jax.ops.segment_sum(val, seg, num_segments=W,
                               indices_are_sorted=True)
    kk = jax.ops.segment_max(jnp.where(is_head, key, -1), seg,
                             num_segments=W, indices_are_sorted=True)
    n_entries = jnp.sum(is_head.astype(jnp.int32))
    keep = jnp.arange(W) < n_entries
    return (jnp.where(keep, kk, 0).astype(jnp.int32),
            jnp.where(keep, data, 0), n_entries)


def spgemm_windowed(A_csr, B_csr, window: int = 1 << 21,
                    batch: int | None = None) -> COO:
    """C = A @ B with O(batch*window) device memory — exact expansion, no
    kB term.

    The symbolic pass (host numpy: count → exclusive scan, the skeleton of
    radix_sort_cpu.hpp:254-322) assigns every partial product A[i,k]*B[k,j]
    one slot in a global expansion of size S = Σ nnz(B row k); slots are
    processed in fixed windows of `window`, `batch` windows per dispatch
    through ONE vmapped jitted program (identical shapes — single
    compilation), and each batch's compacted triplets are accumulated
    host-side. Works at S > 2^31 (offsets are int64 on the host;
    on-device positions are window-relative int32).

    Batching matters: one window costs several host round-trips
    (uploads + scalar sync + pulls); batching cuts them by `batch`.

    Returns canonical sorted COO (exact nnz, duplicates merged). A
    (row, col) pair straddling a window seam yields one partial entry per
    window; windows are internally sorted, so only the shared boundary
    row needs the host merge.

    Values are processed in float32 (the bit-delta reconstruction views
    f32 bit patterns; this rig runs JAX without x64 anyway) — f64 inputs
    are downcast once at entry, explicitly.
    """
    import os

    import numpy as np

    if A_csr.shape[1] != B_csr.shape[0]:
        raise ValueError(f"shape mismatch {A_csr.shape} @ {B_csr.shape}")
    m, n_out = A_csr.shape[0], B_csr.shape[1]
    W = int(window)
    G = int(batch if batch is not None
            else os.environ.get("LIBHPC_SPGEMM_BATCH", "8"))

    # ---- symbolic pass (host) -------------------------------------------
    a_ind = np.asarray(A_csr.indices)
    a_ptr = np.asarray(A_csr.indptr).astype(np.int64)
    b_ptr = np.asarray(B_csr.indptr).astype(np.int64)
    a_dat = np.asarray(A_csr.data)
    lens_all = (b_ptr[a_ind + 1] - b_ptr[a_ind]).astype(np.int64)
    rows_all = np.repeat(np.arange(m, dtype=np.int32), np.diff(a_ptr))
    live = lens_all > 0                      # empty B rows own no slots
    lens_l = lens_all[live]
    if lens_l.size == 0:
        z = jnp.zeros((1,), jnp.int32)
        return COO(row=z, col=z, data=jnp.zeros((1,), jnp.float32),
                   shape=(m, n_out))
    starts = np.concatenate([[0], np.cumsum(lens_l)])   # (nsrc+1,) int64
    S = int(starts[-1])
    rows_l = rows_all[live]
    adata_l = a_dat[live]
    bstart_l = b_ptr[a_ind[live]]            # B row start of each source

    n_win = -(-S // W)
    # per-window source ranges [jlo, jhi): jlo covers the window's slot 0
    w0s = np.arange(n_win, dtype=np.int64) * W
    jlo = np.searchsorted(starts, w0s, side="right") - 1
    jhi = np.searchsorted(starts, np.minimum(w0s + W, S), side="left")
    SRC = int(np.max(jhi - jlo))

    # packed-key feasibility: rel row must fit 31-CBITS bits (see
    # _spgemm_window docstring); expansion slots are row-contiguous so
    # the span shrinks linearly with the window size
    CBITS = max(int(n_out - 1).bit_length(), 1)
    span = int(np.max(rows_l[np.minimum(jhi - 1, rows_l.size - 1)]
                      .astype(np.int64) - rows_l[jlo]))
    if span >= 1 << max(31 - CBITS, 0):
        raise ValueError(
            f"spgemm_windowed: a window spans {span} output rows, too "
            f"wide to pack with {CBITS} column bits — pass a smaller "
            f"`window` (currently {W})")

    batched = jax.jit(
        jax.vmap(partial(_spgemm_window, W=W, SRC=SRC, CBITS=CBITS),
                 in_axes=(0, 0, 0, 0, 0, None, None)))

    if a_dat.dtype != np.float32:   # explicit, documented downcast
        a_dat = a_dat.astype(np.float32)
        adata_l = adata_l.astype(np.float32)
    abits_l = adata_l.view(np.int32)

    def _prep(b0):
        b1 = min(n_win, b0 + G)
        heads_b = np.full((G, SRC), W, np.int32)   # pad sources: dropped
        drel_b = np.zeros((G, SRC), np.int32)
        drow_b = np.zeros((G, SRC), np.int32)
        dab_b = np.zeros((G, SRC), np.int32)
        nval_b = np.zeros((G,), np.int32)          # pad windows: 0 live
        rmin_b = np.zeros((G,), np.int32)
        for i, w in enumerate(range(b0, b1)):
            lo, hi = int(jlo[w]), int(jhi[w])
            w0 = int(w0s[w])
            st = np.maximum(starts[lo:hi], w0)
            heads_b[i, :hi - lo] = (st - w0).astype(np.int32)
            # absolute B index of each source's slots: relabs[j] + s
            relabs = (bstart_l[lo:hi] - starts[lo:hi] + w0).astype(np.int64)
            drel = np.empty(hi - lo, np.int64)
            drel[0] = relabs[0]
            drel[1:] = np.diff(relabs) + 1
            drel_b[i, :hi - lo] = drel.astype(np.int32)
            rw = rows_l[lo:hi].astype(np.int32)
            drow_b[i, 0] = 0
            drow_b[i, 1:hi - lo] = np.diff(rw)
            ab = abits_l[lo:hi].astype(np.int64)
            dab_b[i, 0] = np.int64(ab[0]).astype(np.int32)
            dab_b[i, 1:hi - lo] = np.diff(ab).astype(np.int32)
            nval_b[i] = min(W, S - w0)
            rmin_b[i] = rw[0]
        out = batched(jnp.asarray(heads_b), jnp.asarray(drel_b),
                      jnp.asarray(drow_b), jnp.asarray(dab_b),
                      jnp.asarray(nval_b), B_csr.indices, B_csr.data)
        return out, rmin_b, b1 - b0

    rows_out, cols_out, data_out = [], [], []
    cmask = (1 << CBITS) - 1

    def _pull(out, rmin_b, nb):
        kk, dd, ne = out
        nes = np.asarray(ne)                       # one scalar-vec pull
        # quantized pull width: a fresh slice shape per batch would
        # recompile the fetch each time; 64Ki quanta bound the distinct
        # shapes to <= W/65536
        q = min(W, -(-max(int(nes.max()), 1) // 65536) * 65536)
        kq, dq = jax.device_get((kk[:, :q], dd[:, :q]))
        for i in range(nb):
            k = int(nes[i])
            rows_out.append((kq[i, :k] >> CBITS) + rmin_b[i])
            cols_out.append(kq[i, :k] & cmask)
            data_out.append(dq[i, :k])

    # 1-deep pipeline: dispatch batch b+1 before pulling batch b, so the
    # host pull of one batch overlaps the device compute of the next
    pending = None
    for b0 in range(0, n_win, G):
        nxt = _prep(b0)
        if pending is not None:
            _pull(*pending)
        pending = nxt
    _pull(*pending)

    # merge boundary duplicates: each window is internally (row, col)-
    # sorted and deduped, and consecutive windows share at most the ONE
    # boundary output row (expansion slots are row-contiguous) — so only
    # seam rows need re-merging, not a global 80M-entry lexsort (the r3
    # form spent ~15 s of host time there)
    out_r, out_c, out_d = [], [], []
    pend = None                       # open boundary row (r, c, d)

    def _merge_row(cs, ds):
        order = np.argsort(cs, kind="stable")
        cs, ds = cs[order], ds[order]
        head = np.ones(cs.size, bool)
        head[1:] = cs[1:] != cs[:-1]
        seg = np.cumsum(head) - 1
        dsum = np.zeros(int(seg[-1]) + 1, ds.dtype)
        np.add.at(dsum, seg, ds)
        return cs[head], dsum

    for r, c, d in zip(rows_out, cols_out, data_out):
        if r.size == 0:
            continue
        if pend is not None:
            if r[0] == pend[0][0]:
                cut = int(np.searchsorted(r, r[0], side="right"))
                cs, ds = _merge_row(
                    np.concatenate([pend[1], c[:cut]]),
                    np.concatenate([pend[2], d[:cut]]))
                pend = (np.full(cs.size, r[0], r.dtype), cs, ds)
                r, c, d = r[cut:], c[cut:], d[cut:]
                if r.size == 0:
                    continue      # row continues into the next window
            out_r.append(pend[0])
            out_c.append(pend[1])
            out_d.append(pend[2])
            pend = None
        # hold back this window's last row — the next window may continue it
        cut = int(np.searchsorted(r, r[-1], side="left"))
        pend = (r[cut:], c[cut:], d[cut:])
        out_r.append(r[:cut])
        out_c.append(c[:cut])
        out_d.append(d[:cut])
    if pend is not None:
        out_r.append(pend[0])
        out_c.append(pend[1])
        out_d.append(pend[2])
    r = np.concatenate(out_r) if out_r else np.zeros(0, np.int64)
    c = np.concatenate(out_c) if out_c else np.zeros(0, np.int64)
    d = np.concatenate(out_d) if out_d else np.zeros(0, a_dat.dtype)
    if r.size == 0:
        z = jnp.zeros((1,), jnp.int32)
        return COO(row=z, col=z, data=jnp.zeros((1,), jnp.float32),
                   shape=(m, n_out))
    return COO(row=jnp.asarray(r, jnp.int32),
               col=jnp.asarray(c, jnp.int32),
               data=jnp.asarray(d), shape=(m, n_out))
