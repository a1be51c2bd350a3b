"""Dense matmul — the reference's blocked-matmul workload
(tests/test_hpc_benchmark/test_hpc_benchmark.cpp:758-784: 1024² blocked
matmul) as XLA's dot with a stated precision.

float32 operands run at HIGHEST precision, so the GPU's tensor cores do
not silently round them to TF32; other float dtypes accumulate in f32.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


@jax.jit
def matmul(a, b):
    """C = A @ B with f32 accumulation (A, B any float dtype)."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST,
                   preferred_element_type=jnp.float32).astype(a.dtype)
