"""Device-side invariant checking (SURVEY.md §5.2).

The reference guards kernels with device traps (`asm("trap;")` on
out-of-bounds scatter positions, cuda_radix_scatter.cuh:94,176) and debug
sync-and-check after every launch. The JAX equivalents:

  - `checkify`-wrapped validators for container invariants (jittable)
  - host-side `validate_*` raising ValueError (setup-path checks)
  - `debug_nans` toggle helper
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import checkify


def csr_invariants_checked(csr):
    """jittable checkified validation: indptr monotone & bounded, indices in
    range. Returns (err, ()) — err.throw() raises on violation."""

    def check(csr):
        checkify.check(jnp.all(csr.indptr[1:] >= csr.indptr[:-1]),
                       "indptr not monotone")
        checkify.check(csr.indptr[0] == 0, "indptr[0] != 0")
        checkify.check(csr.indptr[-1] <= csr.nnz, "indptr[-1] > nnz")
        checkify.check(
            jnp.all((csr.indices >= 0) & (csr.indices < csr.shape[1])),
            "column index out of range",
        )
        return ()

    return checkify.checkify(check)(csr)


def validate_csr(csr) -> None:
    """Host-side validation (raises ValueError)."""
    import numpy as np

    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    if indptr[0] != 0:
        raise ValueError("indptr[0] != 0")
    if (np.diff(indptr) < 0).any():
        raise ValueError("indptr not monotone")
    if indptr[-1] > len(indices):
        raise ValueError("indptr[-1] > nnz")
    if len(indices) and (indices.min() < 0 or indices.max() >= csr.shape[1]):
        raise ValueError("column index out of range")


def debug_nans(enable: bool = True) -> None:
    jax.config.update("jax_debug_nans", enable)
