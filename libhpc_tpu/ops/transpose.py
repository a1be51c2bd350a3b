"""Matrix transpose.

Descendant of the reference's bank-conflict-free shared-memory transpose
(lib/gpu/util/include/cudaUtils.cuh:9-37 `kernel_transpose` and the
stall_short testsuite ladder, cuda_tut_stall_short.cuh:6-57). XLA emits its
own tiled shared-memory transpose for `.T` on the GPU, which is the same
design, so the op is the plain form.

Used by the radix pipeline (local↔localT layout flips, SURVEY.md §3.1) and
exposed as a standalone op.
"""

from __future__ import annotations

import jax


@jax.jit
def transpose(x):
    """(M, N) -> (N, M)."""
    return x.T
