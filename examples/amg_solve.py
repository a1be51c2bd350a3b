"""AMG-preconditioned CG on an unstructured SPD operator, single-chip and
distributed.

Run: python examples/amg_solve.py [--cpu-sim] [n_block_rows]
(the single-device part uses the default device; the distributed part
needs 8 devices, or 8 virtual CPU devices with --cpu-sim, which then runs
the whole example on the CPU)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    args = [a for a in sys.argv[1:] if a != "--cpu-sim"]
    cpu_sim = "--cpu-sim" in sys.argv[1:]
    n_block_rows = int(args[0]) if args else 800
    if cpu_sim:
        from libhpc_tpu.parallel.mesh import require_devices

        require_devices(8, cpu_sim=True)
    from libhpc_tpu.bench.matrices import spd_fem

    A = spd_fem(n_block_rows)
    print(f"operator: {A.shape[0]} rows, {A.nnz / 1e6:.2f}M nnz")
    rng = np.random.default_rng(0)
    b = rng.standard_normal(A.shape[0]).astype(np.float32)

    import jax.numpy as jnp

    from libhpc_tpu.ops import multigrid_sbell as amg
    from libhpc_tpu.ops import solver
    from libhpc_tpu.ops.spmv_pallas import sbell_spmv

    t0 = time.perf_counter()
    H = amg.amg_setup(A, n_levels=3)
    print(f"AMG setup: {time.perf_counter() - t0:.1f}s, "
          f"{len(H.levels) + 1} levels")
    if H.levels:
        sb = H.levels[0].sbell
    else:   # tiny operator: coarse-only hierarchy (direct solve)
        from libhpc_tpu.sparse.sbell import SBELL

        sb = SBELL.from_scipy(A)

    t0 = time.perf_counter()
    x, it, _ = amg.amg_pcg(H, lambda v: sbell_spmv(sb, v),
                           jnp.asarray(b), tol=1e-6)
    r = b - A @ np.asarray(x)
    print(f"AMG-PCG: {int(it)} iterations, "
          f"rel res {np.linalg.norm(r) / np.linalg.norm(b):.2e}, "
          f"{time.perf_counter() - t0:.1f}s (incl. compile)")

    _, it_cg, _ = solver.cg(lambda v: sbell_spmv(sb, v), jnp.asarray(b),
                            tol=1e-6, max_iter=1000)
    print(f"plain CG for comparison: {int(it_cg)} iterations")

    # ---- distributed ----------------------------------------------------
    from libhpc_tpu.parallel.dist_amg import dist_amg_pcg
    from libhpc_tpu.parallel.mesh import make_mesh_1d, require_devices

    require_devices(8)

    mesh = make_mesh_1d(8)
    xd, itd, _ = dist_amg_pcg(A, mesh, 8, b, tol=1e-6)
    rd = b - A @ np.asarray(xd)[:A.shape[0]]
    print(f"distributed AMG-PCG (8 shards): {int(itd)} iterations, "
          f"rel res {np.linalg.norm(rd) / np.linalg.norm(b):.2e}")


if __name__ == "__main__":
    main()
