"""Halo-exchange overlap benchmark (the BASELINE.json north-star metric;
configs[3]: 2D/3D stencil row-partitioned across 8 chips).

Measures the distributed stencil with and without the interior/boundary
overlap split (libhpc_tpu.parallel.halo.halo_stencil_overlapped) and reports

  overlap_efficiency = t_unoverlapped / t_overlapped

≥1 means the ppermute halo exchange rides under the interior compute — the
distributed descendant of the reference's stream-overlap pattern-A study
(cuda_tut_transfer_overlap.cu:41-142).

Run: python -m libhpc_tpu.bench.overlap [--cpu-sim] [n_devices] [m] [n]
[radius]. Without --cpu-sim it needs n_devices real devices; with it the
numbers validate plumbing only.
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def run(n_devices: int = 8, m: int = 4096, n: int = 4096, radius: int = 8,
        cpu_sim: bool = False):
    from libhpc_tpu.bench.harness import card, time_iterated
    from libhpc_tpu.parallel.mesh import make_mesh_1d, require_devices
    from libhpc_tpu.parallel.dist_stencil import dist_blur2d_fn

    require_devices(n_devices, cpu_sim)
    mesh = make_mesh_1d(n_devices)
    sh = NamedSharding(mesh, P("x"))
    u = jax.device_put(jnp.ones((m, n), jnp.float32), sh)

    norm = 1.0 / float((2 * radius + 1) ** 2)
    results = {}
    for overlap in (False, True):
        f = dist_blur2d_fn(mesh, radius=radius, overlap=overlap)
        step = lambda v: f(v) * norm  # keep magnitude bounded across iters
        per = time_iterated(step, u, iters=16, iters_small=2)
        results["overlapped" if overlap else "unoverlapped"] = per

    eff = results["unoverlapped"] / results["overlapped"]
    print(json.dumps({
        "bench": "halo_overlap_stencil",
        "n_devices": n_devices,
        "shape": [m, n],
        "radius": radius,
        "ms_unoverlapped": round(results["unoverlapped"] * 1e3, 3),
        "ms_overlapped": round(results["overlapped"] * 1e3, 3),
        "overlap_efficiency": round(eff, 3),
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "card": card(),
    }))
    return eff


if __name__ == "__main__":
    run(*[int(a) for a in sys.argv[1:] if a != "--cpu-sim"],
        cpu_sim="--cpu-sim" in sys.argv[1:])
