"""Distributed SpMV three ways: 1D+all_gather, halo-exchange DIA, 2D SUMMA.

Run: python examples/distributed_spmv.py [--cpu-sim] [n_devices]
(--cpu-sim runs on n virtual CPU devices; without it n real devices are
required)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from libhpc_tpu.bench.matrices import poisson2d


def main(nd=8, cpu_sim=False):
    from libhpc_tpu.parallel.mesh import make_mesh_1d, require_devices

    require_devices(nd, cpu_sim)
    A = poisson2d(64)  # 4096 rows
    x = np.random.default_rng(0).random(A.shape[0]).astype(np.float32)
    y_ref = A @ x

    mesh = make_mesh_1d(nd)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("x")))

    from libhpc_tpu.parallel.dist_spmv import DistCSR, dist_spmv_fn

    y1 = dist_spmv_fn(DistCSR.from_scipy(A, nd).shard(mesh), mesh)(xs)
    print("1D CSR + all_gather:", np.allclose(y1, y_ref, atol=1e-3))

    from libhpc_tpu.parallel.dist_dia import DistDIA, dist_dia_spmv_fn

    y2 = dist_dia_spmv_fn(DistDIA.from_scipy(A, nd).shard(mesh), mesh)(xs)
    print("halo-exchange DIA:  ", np.allclose(y2, y_ref, atol=1e-3))

    from libhpc_tpu.parallel.dist2d import Dist2DCSR, dist2d_spmv_fn

    mesh2 = jax.make_mesh((2, nd // 2), ("py", "px"))
    x2 = jax.device_put(jnp.asarray(x), NamedSharding(mesh2, P("px")))
    y3 = dist2d_spmv_fn(Dist2DCSR.from_scipy(A, (2, nd // 2)).shard(mesh2),
                        mesh2, realign=False)(x2)
    print("2D SUMMA:           ", np.allclose(y3, y_ref, atol=1e-3))


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu-sim"]
    main(int(args[0]) if args else 8, cpu_sim="--cpu-sim" in sys.argv[1:])
