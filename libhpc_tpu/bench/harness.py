"""Benchmark + roofline harness (SURVEY.md §5.5: structured JSON results).

Every timing here:

  1. iterates the op M times *inside one jitted program* with
     `lax.optimization_barrier` between iterations (prevents fusion/DCE),
  2. forces completion by fetching a scalar probe that data-depends on the
     final iterate,
  3. uses the delta between a large and a small M to cancel dispatch,
     fetch, and program-entry overhead,
  4. repeats and takes the minimum (the noise floor is one-sided).

This replaces the reference's cudaEvent harness
(tests/test_gpu_benchmark/test_gpu_benchmark.cpp:96-126) with in-program
iteration, which gives the same isolation.

Roofline denominators come from PEAKS, one table keyed by the device's
`device_kind`, with its source; a device missing from it is an error.
"""

from __future__ import annotations

import subprocess
import time
from functools import lru_cache, partial

import jax
import jax.numpy as jnp


def _probe(tree):
    """Cheap scalar that depends on every leaf of the output."""
    leaves = jax.tree_util.tree_leaves(tree)
    acc = jnp.zeros((), jnp.float32)
    for leaf in leaves:
        # full reduction (not a slice): stays legal on sharded arrays,
        # and still data-depends on every element of the output
        acc = acc + jnp.sum(leaf).astype(jnp.float32)
    return acc


def time_iterated(step_fn, x0, iters: int = 32, iters_small: int = 4,
                  reps: int = 3, operand=None) -> float:
    """Seconds per application of step_fn (x -> x-like), delta method.

    operand: optional pytree passed as step_fn(x, operand) and fed to the
    jit as an ARGUMENT — pass large matrices this way, never close over
    them (closed-over arrays become compile-time constants embedded in
    the program)."""

    @partial(jax.jit, static_argnums=(2,))
    def runner(x, op, m):
        def body(_, x):
            y = step_fn(x) if op is None else step_fn(x, op)
            return jax.tree_util.tree_map(jax.lax.optimization_barrier, y)
        out = jax.lax.fori_loop(0, m, body, x)
        return _probe(out)

    def fetch(m):
        return float(runner(x0, operand, m))

    fetch(iters_small)  # compile small
    fetch(iters)        # compile large

    def tmin(m):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fetch(m)
            best = min(best, time.perf_counter() - t0)
        return best

    t_small = tmin(iters_small)
    t_large = tmin(iters)
    per = (t_large - t_small) / (iters - iters_small)
    return max(per, 1e-9)


# Published peaks (dense, no sparsity), keyed by jax device_kind.
PEAKS = {
    "NVIDIA H200": dict(
        hbm_bytes_per_s=4.8e12, bf16_flops=989e12, f32_flops=67e12,
        l2_bytes=50 * 1024 * 1024,
        source="NVIDIA H200 data sheet, SXM part, at its 700 W limit"),
}


@lru_cache(maxsize=None)
def card() -> str | None:
    """`name, power.limit` of the first GPU as nvidia-smi reports them
    (from a child process that never imports JAX), or None without one.
    Printed beside every number measured on a card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def device_peaks(device_kind: str) -> dict:
    """Published peaks of a device; an unknown device is an error."""
    if device_kind not in PEAKS:
        raise KeyError(f"no published peaks for device_kind "
                       f"{device_kind!r}; add it to harness.PEAKS")
    return PEAKS[device_kind]


def measure_hbm_bandwidth(nbytes: int = 1 << 30, dtype=jnp.float32) -> float:
    """Measured copy rate: bytes/s of x *= c streaming passes (counts read
    + write traffic of a 50/50 mix). The 1 GiB default is 20x the 50 MB
    L2 of the cards in PEAKS, so the passes stream from device memory."""
    n = nbytes // jnp.dtype(dtype).itemsize
    x = jnp.full((n,), 1.0, dtype)
    per = time_iterated(lambda v: v * 1.0000001, x, iters=36, iters_small=4)
    return 2 * nbytes / per


def measure_hbm_read_bandwidth(nbytes: int = 1 << 29,
                               dtype=jnp.float32) -> float:
    """Measured read rate: bytes/s of fused max-reduce passes (the
    reduction fuses the elementwise op, so nothing is written back).
    SpMV streams are read-dominated, so this is the rate they approach."""
    n = nbytes // jnp.dtype(dtype).itemsize
    x = jnp.full((n,), 1.0, dtype)

    @partial(jax.jit, static_argnums=(1,))
    def runner(x, m):
        def body(i, acc):
            # iteration-dependent MAX (not a multiply: XLA factors
            # sum(x*c) into c*sum(x) and hoists the whole read); max
            # fuses into the reduce (no temp written) and cannot be
            # factored out
            return acc + jnp.sum(
                jnp.maximum(x, 1e-9 * i.astype(jnp.float32)))
        return jax.lax.fori_loop(0, m, body, jnp.zeros((), jnp.float32))

    def fetch(m):
        return float(runner(x, m))

    # default 512 MB: far past the 50 MB L2, so every pass streams from
    # device memory
    fetch(2)
    fetch(12)

    def tmin(m, reps=3):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            fetch(m)
            best = min(best, time.perf_counter() - t0)
        return best

    per = max((tmin(12) - tmin(2)) / 10, 1e-9)
    return nbytes / per


def spmv_bytes(nnz: int, nrows: int, ncols: int, dtype_size: int = 4,
               index_size: int = 4) -> int:
    """Minimum HBM traffic for one CSR SpMV (roofline numerator):
    values + column indices + one read of x + one write of y + indptr."""
    return (
        nnz * (dtype_size + index_size)
        + ncols * dtype_size
        + nrows * dtype_size
        + (nrows + 1) * index_size
    )


def format_spmv_bytes(fmt, obj, nrows: int, ncols: int) -> int:
    """Per-format HBM traffic model: count the bytes the
    format ACTUALLY streams (its stored values + index arrays + x + y) so
    roofline fractions are physically <= 1 for every format."""
    xy = (nrows + ncols) * 4
    if fmt == "csr":
        return spmv_bytes(obj.data.size, nrows, ncols)
    if fmt == "ell":
        return obj.vals.size * (4 + 4) + xy
    if fmt == "dia":
        return obj.data.size * 4 + obj.ndiags * 4 + xy
    if fmt == "bell":
        return obj.blocks.size * 4 + obj.indices.size * 4 + xy
    if fmt == "sbell":
        return obj.hbm_bytes
    raise KeyError(fmt)
