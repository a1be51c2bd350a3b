"""Micro-architecture truth suite — committed, reproducible, JSON-emitting.

The re-expression of the reference's GPU testsuites
(lib/gpu/{stall_lg,stall_short,mio_throttle,transfer_overlap}_testsuite:
first-class executables measuring the hardware facts the kernels are
designed around), in plain XLA so it runs on any backend:

  gather_row_width  XLA row-gather rate vs row width (the per-row gather
                    cost that shapes the block formats)
  scatter_modes     scatter-add w/ dup keys, permutation scatter/gather,
                    segment_sum

Run:  python -m libhpc_tpu.bench.microarch [name ...]
Emits one JSON line per measurement, naming the device it ran on. All
timings use the barrier/delta harness discipline; gather inputs are
runtime-perturbed so XLA cannot hoist them out of the timing loop.
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from libhpc_tpu.bench.harness import time_iterated


def _emit(name: str, **fields):
    from libhpc_tpu.bench.harness import card

    dev = jax.devices()[0]
    d = {"bench": name, "platform": dev.platform, "kind": dev.device_kind,
         "card": card()}
    d.update({k: (round(v, 4) if isinstance(v, float) else v)
              for k, v in fields.items()})
    print(json.dumps(d), flush=True)


def _live_flag(v):
    """A runtime-dependent int32 that always equals 1 — multiplied into
    indices so gathers stay inside the timed loop (anti-hoisting)."""
    leaf = jax.tree_util.tree_leaves(v)[0]
    return (leaf.reshape(-1)[0] < jnp.inf).astype(jnp.int32)


def bench_gather_row_width(n_rows: int = 1 << 17, m: int = 1 << 17):
    """XLA row-gather rate vs row width b (the cost is per ROW)."""
    rng = np.random.default_rng(0)
    idx = jnp.asarray(rng.integers(0, n_rows, m, dtype=np.int32))
    for b in (1, 8, 16, 128):
        tab = jnp.asarray(rng.random((n_rows, b), np.float32))

        def step(v, tab=tab):
            g = tab[idx * _live_flag(v)]
            return v + g.sum(axis=1)

        per = time_iterated(step, jnp.zeros((m,), jnp.float32), iters=8,
                            iters_small=1)
        _emit("gather_row_width", b=b, g_rows_per_s=m / per / 1e9,
              gb_per_s=m * b * 4 / per / 1e9)


def bench_scatter_modes(n: int = 1 << 20):
    rng = np.random.default_rng(1)
    dup = jnp.asarray(rng.integers(0, n // 4, n, dtype=np.int32))
    perm = jnp.asarray(rng.permutation(n).astype(np.int32))
    modes = {
        "scatter_add_dup": lambda v: jnp.zeros_like(v).at[
            dup * _live_flag(v)].add(v),
        "scatter_perm": lambda v: jnp.zeros_like(v).at[
            perm * _live_flag(v)].set(v),
        "gather_perm": lambda v: v[perm * _live_flag(v)],
        "segment_sum": lambda v: jax.ops.segment_sum(
            v, dup * _live_flag(v), num_segments=n),
    }
    for name, fn in modes.items():
        per = time_iterated(fn, jnp.ones((n,), jnp.float32), iters=8,
                            iters_small=1)
        _emit("scatter_modes", mode=name, g_writes_per_s=n / per / 1e9)


ALL = {
    "gather_row_width": bench_gather_row_width,
    "scatter_modes": bench_scatter_modes,
}


def main(argv):
    for n in argv or list(ALL):
        ALL[n]()


if __name__ == "__main__":
    from libhpc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    main(sys.argv[1:])
