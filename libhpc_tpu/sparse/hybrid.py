"""Banded-hybrid format: RCM reordering + DIA band + sparse remainder.

An answer to unstructured SpMV when scalar gathers are expensive and
shifted streams are cheap: reorder the matrix with reverse Cuthill–McKee to concentrate
nnz near the diagonal, store the K most-populated diagonals as DIA
(zero-gather), and keep the leftover entries in ELL (gather-bound but
small). SpMV = dia_spmv + ell_spmv on the permuted vector.

The effectiveness knob is `coverage` = fraction of nnz captured by the
band — reported so users can see the gather exposure. Setup is host-side
scipy (one-time); the hot path is jitted.

Applicability: quasi-structured matrices
(stencils, banded FD/FV, tensor-product operators) reach coverage ≈ 1 and
run at DIA speed. General FEM matrices (cant/pwtk class) stay sparse
*inside* their RCM band — a diagonal census captures only ~20% — so their
production path remains BSR (block row-gather amortization), not this
hybrid.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from libhpc_tpu.sparse.dia import DIA
from libhpc_tpu.sparse.ell import ELL


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BandedHybrid:
    """A = P^T (band + rest) P with permutation P (RCM or identity).

    perm: int32 (n,) — row/col permutation applied to the matrix
    (A_perm = A[perm][:, perm]); spmv computes in permuted space and maps
    back, so callers see original-order vectors.
    """

    band: DIA
    rest: ELL
    perm: jax.Array
    iperm: jax.Array
    shape: tuple = dataclasses.field(metadata=dict(static=True))
    coverage: float = dataclasses.field(metadata=dict(static=True))

    @staticmethod
    def from_scipy(sp, max_diags: int = 32, rcm: bool = True,
                   pad_multiple: int = 8) -> "BandedHybrid":
        import scipy.sparse as sps
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        sp = sps.csr_matrix(sp)
        n = sp.shape[0]
        if sp.shape[0] != sp.shape[1]:
            raise ValueError("hybrid format assumes a square matrix")
        if rcm:
            perm = np.asarray(
                reverse_cuthill_mckee(sp, symmetric_mode=False), np.int32
            )
        else:
            perm = np.arange(n, dtype=np.int32)
        iperm = np.empty_like(perm)
        iperm[perm] = np.arange(n, dtype=np.int32)
        A = sp[perm][:, perm].tocoo()

        # diagonal population census
        offs = A.col.astype(np.int64) - A.row.astype(np.int64)
        uniq, counts = np.unique(offs, return_counts=True)
        order = np.argsort(-counts)
        band_offs = set(int(o) for o in uniq[order[:max_diags]])
        in_band = np.fromiter((int(o) in band_offs for o in offs), bool,
                              len(offs))
        coverage = float(in_band.sum()) / max(len(offs), 1)

        band_coo = sps.coo_matrix(
            (A.data[in_band], (A.row[in_band], A.col[in_band])), shape=A.shape
        )
        rest_coo = sps.coo_matrix(
            (A.data[~in_band], (A.row[~in_band], A.col[~in_band])),
            shape=A.shape,
        )
        band = DIA.from_scipy(band_coo)
        rest = ELL.from_scipy(rest_coo.tocsr(), pad_multiple=pad_multiple)
        return BandedHybrid(
            band=band, rest=rest,
            perm=jnp.asarray(perm), iperm=jnp.asarray(iperm),
            shape=sp.shape, coverage=coverage,
        )

    def __matmul__(self, x):
        from libhpc_tpu.ops.spmv import hybrid_spmv

        return hybrid_spmv(self, jnp.asarray(x))
