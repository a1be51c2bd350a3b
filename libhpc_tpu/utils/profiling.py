"""Tracing / profiling helpers (SURVEY.md §5.1).

The reference brackets every pipeline stage with NVTX ranges
(cuda_radix_sort_v4.cu:99-211) for Nsight timelines. The JAX equivalents:
`jax.named_scope` (shows up in XLA HLO + profiler timelines), `jax.profiler`
trace capture, and a tiny scoped wall-timer for host-side phases.
"""

from __future__ import annotations

import contextlib
import time

import jax

# re-export: use as `with annotate("histogram"): ...` inside traced code
annotate = jax.named_scope


@contextlib.contextmanager
def trace_to(logdir: str):
    """Capture a profiler trace (viewable in TensorBoard or Perfetto)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def wall_timer(label: str, results: dict | None = None):
    """Host-phase timer; appends seconds into `results[label]` if given."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        if results is not None:
            results[label] = dt
