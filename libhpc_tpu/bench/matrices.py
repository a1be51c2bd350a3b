"""Benchmark matrix generators (BASELINE.json configs).

SuiteSparse downloads are unavailable (zero-egress image), so `cant` and
`pwtk` are modeled by synthetic stand-ins with the same structural
statistics (size, nnz/row, block structure); the generators are
deterministic so results are comparable across rounds. If real .mtx files
are present under $LIBHPC_MATRIX_DIR they are loaded instead (via the
native MatrixMarket loader when built, else scipy).
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sps


def poisson2d(n: int, dtype=np.float32) -> sps.csr_matrix:
    """5-point Poisson on an n×n grid: the configs[0] matrix
    (10k×10k when n=100; BASELINE uses a 10k-row system)."""
    d = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    I = sps.identity(n)
    return (sps.kron(I, d) + sps.kron(d, I)).tocsr().astype(dtype)


def poisson3d(n: int, dtype=np.float32) -> sps.csr_matrix:
    d = sps.diags([-1.0, 2.0, -1.0], [-1, 0, 1], shape=(n, n))
    I = sps.identity(n)
    A = (
        sps.kron(sps.kron(I, I), d)
        + sps.kron(sps.kron(I, d), I)
        + sps.kron(sps.kron(d, I), I)
    )
    return A.tocsr().astype(dtype)


def block_random(n_block_rows: int, block: int = 8,
                 blocks_per_row: int = 8, seed: int = 0,
                 half_band: int = 4, far_fraction: float = 0.02,
                 dtype=np.float32) -> sps.csr_matrix:
    """Synthetic FEM-like matrix: dense b×b blocks clustered in a band of
    ±half_band block-columns around the diagonal, plus a small
    `far_fraction` of uniformly random block columns. Stand-in generator
    for cant/pwtk-style structure.

    Faithfulness note: real SuiteSparse cant/pwtk are FEM meshes — their
    nonzeros sit in a tight diagonal band (mesh-local connectivity), with
    no uniform long-range coupling. An earlier version of this generator
    sprayed 2/9 of all blocks uniformly at random, an adversarial pattern
    no FEM matrix has, which benchmarked the gather fallback instead of
    the banded fast path. far_fraction keeps a small honest tail of
    long-range entries (constraint-style couplings)."""
    rs = np.random.RandomState(seed)
    n = n_block_rows * block
    rows, cols, vals = [], [], []
    n_far_rows = max(1, int(far_fraction * n_block_rows * blocks_per_row))
    far_rows = set(rs.randint(0, n_block_rows, size=n_far_rows))
    for br in range(n_block_rows):
        near = br + rs.randint(-half_band, half_band + 1,
                               size=blocks_per_row - 1)
        extra = (rs.randint(0, n_block_rows, size=1)
                 if br in far_rows else np.empty(0, np.int64))
        bcs = np.unique(np.clip(np.concatenate([near, extra, [br]]), 0,
                                n_block_rows - 1))
        for bc in bcs:
            r0, c0 = br * block, bc * block
            rr, cc = np.meshgrid(np.arange(block), np.arange(block),
                                 indexing="ij")
            rows.append((r0 + rr).ravel())
            cols.append((c0 + cc).ravel())
            vals.append(rs.randn(block * block).astype(dtype))
    A = sps.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    ).tocsr()
    A.sum_duplicates()
    return A


def block_random_fast(n_block_rows: int, block: int = 8,
                      blocks_per_row: int = 8, seed: int = 0,
                      half_band: int = 6, far_fraction: float = 0.02,
                      dtype=np.float32) -> sps.csr_matrix:
    """Vectorized block_random for 100M-nnz-class matrices (the per-row
    python loop of block_random takes minutes past ~1M rows). Same
    structural statistics: dense b×b blocks in a ±half_band block-column
    band plus a far_fraction tail of random long-range blocks; duplicate
    block columns are summed by the CSR conversion (slightly fewer
    distinct blocks than blocks_per_row — same as the loop generator after
    its np.unique)."""
    rs = np.random.RandomState(seed)
    nbr = n_block_rows
    b = block
    br = np.arange(nbr, dtype=np.int64)
    # band candidates (diag + bpr-1 random in-band), clipped
    offs = rs.randint(-half_band, half_band + 1,
                      size=(nbr, blocks_per_row - 1))
    cols = np.concatenate([br[:, None], br[:, None] + offs], axis=1)
    np.clip(cols, 0, nbr - 1, out=cols)
    # far tail: far_fraction of all blocks re-aimed uniformly
    n_far = int(far_fraction * nbr * blocks_per_row)
    if n_far:
        fr = rs.randint(0, nbr, size=n_far)
        fc = rs.randint(0, blocks_per_row, size=n_far)
        cols[fr, fc] = rs.randint(0, nbr, size=n_far)
    data = rs.standard_normal(
        (nbr * blocks_per_row, b, b)).astype(dtype)
    indptr = np.arange(nbr + 1, dtype=np.int64) * blocks_per_row
    # BSR requires sorted columns per row for downstream .tocsr sanity
    cols.sort(axis=1)
    A = sps.bsr_matrix((data, cols.reshape(-1), indptr),
                       shape=(nbr * b, nbr * b)).tocsr()
    A.sum_duplicates()
    return A


def cant_like(dtype=np.float32) -> sps.csr_matrix:
    """Stand-in for SuiteSparse `cant` (FEM cantilever: 62k rows, ~4M nnz,
    ~64 nnz/row in 8-ish blocks, tightly banded mesh connectivity)."""
    return block_random(62_000 // 8, block=8, blocks_per_row=8, seed=1,
                        half_band=6, far_fraction=0.02, dtype=dtype)


def pwtk_like(dtype=np.float32) -> sps.csr_matrix:
    """Stand-in for SuiteSparse `pwtk` (wind tunnel: 218k rows, ~11.5M nnz,
    wider FEM band than cant)."""
    return block_random(218_000 // 8, block=8, blocks_per_row=7, seed=2,
                        half_band=40, far_fraction=0.02, dtype=dtype)


def spd_from(A: sps.csr_matrix) -> sps.csr_matrix:
    """SPD operator with A's sparsity: A + A^T + diag(|A + A^T| rowsum + 1)
    (symmetric, strictly diagonally dominant)."""
    S = (A + A.T).tocsr()
    rowsum = np.asarray(np.abs(S).sum(axis=1)).ravel()
    return (S + sps.diags(rowsum + 1.0)).tocsr().astype(np.float32)


def spd_fem(n_block_rows: int, seed: int = 11) -> sps.csr_matrix:
    """SPD FEM-class operator for the solvers (spd_from of block_random)."""
    return spd_from(block_random(n_block_rows, block=8, blocks_per_row=6,
                                 seed=seed, half_band=5, far_fraction=0.02))


def irregular_band(n: int, per_row: int = 4, half_width: int = 120,
                   seed: int = 0) -> sps.csr_matrix:
    """Scalar-irregular banded matrix: per_row random entries per row
    within +-half_width of the diagonal (many distinct diagonals, no 8x8
    block density) — the scalar-regular auto_format route's class."""
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = np.clip(rows + rng.integers(-half_width, half_width + 1,
                                       rows.size), 0, n - 1)
    A = sps.coo_matrix((np.ones(rows.size, np.float32), (rows, cols)),
                       shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


def load_or_synthesize(name: str) -> sps.csr_matrix:
    """Load $LIBHPC_MATRIX_DIR/<name>.mtx if present, else synthesize."""
    mdir = os.environ.get("LIBHPC_MATRIX_DIR", "")
    path = os.path.join(mdir, f"{name}.mtx") if mdir else ""
    if path and os.path.exists(path):
        try:
            from libhpc_tpu.runtime.native import load_mtx_native

            return load_mtx_native(path)
        except Exception:
            import scipy.io as sio

            return sio.mmread(path).tocsr()
    gen = {"cant": cant_like, "pwtk": pwtk_like}
    if name in gen:
        return gen[name]()
    raise KeyError(name)
