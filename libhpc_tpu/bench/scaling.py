"""Weak-scaling SpMV benchmarks (BASELINE.md: ≥85% nnz/s efficiency at 2+
hosts; configs[4]: multi-host SpMV on a 100M-nnz-class matrix).

Weak scaling: each shard owns a fixed number of rows; efficiency =
(nnz/s at n shards) / (n × nnz/s at 1 shard). Two curves:

  weak_scaling_spmv   DistDIA on a Poisson band — the structured path.
  weak_scaling_sbell  DistSBELL on an unstructured 8×8-block FEM-like
                      matrix (the actual BASELINE weak-scaling workload:
                      100M-nnz *unstructured*).

Run: python -m libhpc_tpu.bench.scaling [--cpu-sim] [rows_per_shard]
[max_devices]. Without --cpu-sim it needs max_devices real devices; on
the CPU simulation it validates the scaling harness only.
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P


def _device_counts(max_devices: int):
    sizes = [1]
    d = 2
    while d <= max_devices:
        sizes.append(d)
        d *= 2
    return sizes


def _emit_curve(name: str, rows_per_shard: int, out: dict):
    from libhpc_tpu.bench.harness import card

    print(json.dumps({
        "bench": name,
        "rows_per_shard": rows_per_shard,
        "results": out,
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "card": card(),
    }), flush=True)


def run_dia(rows_per_shard: int = 65536, max_devices: int = 8,
            cpu_sim: bool = False):
    import numpy as np

    from libhpc_tpu.bench.harness import time_iterated
    from libhpc_tpu.bench.matrices import poisson2d
    from libhpc_tpu.parallel.mesh import make_mesh_1d, require_devices
    from libhpc_tpu.parallel.dist_dia import DistDIA, dist_dia_spmv_fn

    require_devices(max_devices, cpu_sim)

    out = {}
    base_nnz_rate = None
    for nd in _device_counts(max_devices):
        n_rows = rows_per_shard * nd
        g = int(np.sqrt(n_rows))
        A = poisson2d(g)
        nnz = A.nnz
        mesh = make_mesh_1d(nd)
        dA = DistDIA.from_scipy(A, nd).shard(mesh)
        matvec = dist_dia_spmv_fn(dA, mesh)  # halo-exchange banded path
        x = jax.device_put(
            jnp.ones((dA.shape[0],), jnp.float32), NamedSharding(mesh, P("x"))
        )
        per = time_iterated(matvec, x, iters=16, iters_small=2)
        rate = nnz / per
        if base_nnz_rate is None:
            base_nnz_rate = rate
        out[nd] = dict(
            ms=round(per * 1e3, 3),
            gnnz_per_s=round(rate / 1e9, 3),
            efficiency=round(rate / (base_nnz_rate * nd), 3),
        )
    _emit_curve("weak_scaling_spmv", rows_per_shard, out)
    return out


def run_sbell(rows_per_shard: int = 65536, max_devices: int = 8,
              blocks_per_row: int = 8, half_band: int = 6,
              cpu_sim: bool = False):
    """DistSBELL weak scaling on an unstructured FEM-like matrix.

    Same efficiency math as run_dia; the workload is the block_random
    generator (the cant/pwtk structural stand-in) grown with the shard
    count, through the overlapped all_gather + SBELL path."""
    from libhpc_tpu.bench.harness import time_iterated
    from libhpc_tpu.bench.matrices import block_random
    from libhpc_tpu.parallel.mesh import make_mesh_1d, require_devices
    from libhpc_tpu.parallel.dist_sbell import (DistSBELL,
                                                dist_sbell_spmv_fn)

    require_devices(max_devices, cpu_sim)

    out = {}
    base_nnz_rate = None
    for nd in _device_counts(max_devices):
        n_rows = rows_per_shard * nd
        A = block_random(n_rows // 8, blocks_per_row=blocks_per_row,
                         half_band=half_band, seed=nd)
        nnz = A.nnz
        mesh = make_mesh_1d(nd)
        dA = DistSBELL.from_scipy(A, nd).shard(mesh)
        matvec = dist_sbell_spmv_fn(dA, mesh)
        x = jax.device_put(
            jnp.ones((dA.shape[0],), jnp.float32), NamedSharding(mesh, P("x"))
        )
        per = time_iterated(matvec, x, iters=16, iters_small=2)
        rate = nnz / per
        if base_nnz_rate is None:
            base_nnz_rate = rate
        out[nd] = dict(
            ms=round(per * 1e3, 3),
            gnnz_per_s=round(rate / 1e9, 3),
            efficiency=round(rate / (base_nnz_rate * nd), 3),
        )
    _emit_curve("weak_scaling_sbell", rows_per_shard, out)
    return out


def run(rows_per_shard: int = 65536, max_devices: int = 8,
        cpu_sim: bool = False):
    dia = run_dia(rows_per_shard, max_devices, cpu_sim)
    sbell = run_sbell(rows_per_shard, max_devices, cpu_sim=cpu_sim)
    return {"dia": dia, "sbell": sbell}


if __name__ == "__main__":
    run(*[int(a) for a in sys.argv[1:] if a != "--cpu-sim"],
        cpu_sim="--cpu-sim" in sys.argv[1:])
