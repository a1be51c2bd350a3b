"""Distributed AMG-preconditioned CG over the mesh.

Two-level aggregation AMG where the FINE level is the row-partitioned
DistSBELL matvec (parallel/dist_sbell.py — all_gather overlapped with the
diagonal block) and the coarse level is a replicated dense inverse
(coarse operators are a few thousand rows — one dense matvec at HIGHEST
precision).

Everything between is plain JAX on sharded arrays: Jacobi sweeps are
elementwise, restriction is a segment_sum over global aggregate ids
(GSPMD inserts the cross-shard reduction), prolongation is a gather from
the replicated coarse solution. The V-cycle is SPD (symmetric pre/post
smoothing), so it drops into ops/solver.py:pcg_op unchanged.

This is new capability beyond the reference (SURVEY.md §5.8: the
distributed layer is required new work); it composes the flagship
unstructured kernel with the solver stack at multi-chip scale.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libhpc_tpu.ops.multigrid_sbell import _aggregate
from libhpc_tpu.parallel.dist_sbell import (DistSBELL, dist_sbell_spmv_apply,
                                            dist_sbell_spmv_fn)


def _vcycle(st, f, *, mesh: Mesh, axis: str, nc: int, pre: int, post: int):
    """Two-level V-cycle over sharded padded vectors; st = (dA, dinv,
    aggp, coarse_inv) is an operand, never a compile-time constant."""
    dA, dinv, aggp, coarse_inv = st

    def matvec(v):
        return dist_sbell_spmv_apply(dA, v, mesh, axis)

    u = dinv * f
    for _ in range(pre - 1):
        u = u + dinv * (f - matvec(u))
    r = f - matvec(u)
    rc = jax.ops.segment_sum(r, aggp, num_segments=nc + 1)[:nc]
    ec = jnp.dot(coarse_inv, rc, precision=jax.lax.Precision.HIGHEST)
    ecp = jnp.concatenate([ec, jnp.zeros((1,), ec.dtype)])
    u = u + ecp[aggp]
    for _ in range(post):
        u = u + dinv * (f - matvec(u))
    return u


def _setup(A, mesh: Mesh, n_shards: int, axis: str = "x",
           theta: float = 0.25, omega: float = 0.65, pre: int = 2,
           post: int = 2, coarse_hard_max: int = 8000):
    """Host-side setup. Returns (st, vcycle(st, f), b_shard)."""
    # pre >= 1 is structural (the first sweep starts from the zero
    # guess); pre == post keeps the V-cycle SPD — a requirement for its
    # role as the CG preconditioner (as in amg_setup)
    if pre < 1 or post < 1:
        raise ValueError(f"dist_amg_build: pre/post sweeps must be >= 1 "
                         f"(got pre={pre}, post={post})")
    if pre != post:
        raise ValueError(
            f"dist_amg_build: pre ({pre}) != post ({post}) makes the "
            "V-cycle non-symmetric — not a valid CG preconditioner")
    import scipy.sparse as sps

    A = sps.csr_matrix(A).astype(np.float32)
    n = A.shape[0]
    dA = DistSBELL.from_scipy(A, n_shards).shard(mesh, axis)
    n_pad = dA.shape[0]

    agg, nc = _aggregate(A, theta)
    if nc > coarse_hard_max:
        raise ValueError(
            f"dist_amg_build: coarse level has {nc} rows "
            f"(> {coarse_hard_max}); aggregation failed to coarsen")
    P_t = sps.csr_matrix(
        (np.ones(n, np.float32), (np.arange(n), agg)), shape=(n, nc))
    Ac = (P_t.T @ A @ P_t).tocsr()
    coarse_inv = jnp.asarray(
        np.linalg.inv(Ac.toarray().astype(np.float64)).astype(np.float32))

    diag = np.zeros(n_pad, np.float32)
    diag[:n] = A.diagonal()
    dinv_np = np.zeros(n_pad, np.float32)
    nz = diag != 0.0
    dinv_np[nz] = omega / diag[nz]
    aggp_np = np.full(n_pad, nc, np.int32)     # padding rows -> dummy agg
    aggp_np[:n] = agg

    sh = NamedSharding(mesh, P(axis))
    dinv = jax.device_put(jnp.asarray(dinv_np), sh)
    aggp = jax.device_put(jnp.asarray(aggp_np), sh)

    def b_shard(b_host):
        b = np.zeros(n_pad, np.float32)
        b[:n] = np.asarray(b_host, np.float32)
        return jax.device_put(jnp.asarray(b), sh)

    vcycle = partial(_vcycle, mesh=mesh, axis=axis, nc=nc, pre=pre,
                     post=post)
    return (dA, dinv, aggp, coarse_inv), vcycle, b_shard


def dist_amg_build(A, mesh: Mesh, n_shards: int, axis: str = "x", **kw):
    """Host-side setup. Returns (vcycle, matvec, b_shard) where vcycle is
    the SPD preconditioner operator over sharded padded vectors, matvec
    the distributed fine operator, and b_shard pads+shards a host rhs."""
    st, vcycle, b_shard = _setup(A, mesh, n_shards, axis, **kw)
    return (partial(jax.jit(vcycle), st),
            dist_sbell_spmv_fn(st[0], mesh, axis), b_shard)


def dist_amg_pcg(A, mesh: Mesh, n_shards: int, b, tol: float = 1e-6,
                 max_iter: int = 200, axis: str = "x", **kw):
    """One-call distributed AMG-PCG solve of A x = b, one jitted program
    with the hierarchy as an operand. Returns (x_sharded_padded, iters,
    res2); x[:n] is the solution."""
    from libhpc_tpu.ops.solver import pcg_op

    st, vcycle, b_shard = _setup(A, mesh, n_shards, axis, **kw)

    @jax.jit
    def run(st, b):
        return pcg_op(partial(dist_sbell_spmv_apply, st[0], mesh=mesh,
                              axis=axis),
                      partial(vcycle, st), b, tol=tol, max_iter=max_iter)

    return run(st, b_shard(b))
