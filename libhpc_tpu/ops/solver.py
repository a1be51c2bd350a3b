"""Iterative-solver building blocks: axpy/dot/norm + CG (BASELINE.json configs[2]).

The solver loop is a `lax.while_loop` so the whole iteration compiles into
one XLA program — no host round-trips per iteration (the analog of the
reference's fully-async release path within a radix round,
cuda_radix_sort_v4.cu:104-221).

Works with any matrix container that supports `@` (CSR/ELL/BSR) or with an
arbitrary matvec callable (used by the distributed SpMV in
libhpc_tpu.parallel for multi-chip CG).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


@jax.jit
def axpy(a, x, y):
    """a*x + y."""
    return a * x + y


@jax.jit
def dot(x, y):
    return jnp.vdot(x, y)


def _sdot(x, y):
    """Sharding-safe dot: elementwise multiply (same sharding) + full
    reduction — avoids ambiguous contraction sharding under jit on sharded
    inputs, and XLA emits the psum over the mesh axis automatically."""
    return jnp.sum(x * y)


@jax.jit
def norm2(x):
    return jnp.sqrt(jnp.vdot(x, x))


class CGState(NamedTuple):
    x: jax.Array
    r: jax.Array
    p: jax.Array
    rs: jax.Array
    it: jax.Array


@partial(jax.jit, static_argnames=("matvec", "max_iter"))
def cg(matvec: Callable, b, x0=None, tol: float = 1e-6, max_iter: int = 1000):
    """Conjugate gradient for SPD systems. Returns (x, n_iters, final_res2).

    matvec must be a jit-traceable closure (e.g. ``lambda v: A @ v``).
    """
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    rs0 = _sdot(r0, r0)
    tol2 = jnp.asarray(tol, b.dtype) ** 2 * jnp.maximum(
        _sdot(b, b), jnp.ones((), b.dtype)
    )

    def cond(s: CGState):
        return (s.rs > tol2) & (s.it < max_iter)

    def body(s: CGState):
        Ap = matvec(s.p)
        alpha = s.rs / _sdot(s.p, Ap)
        x = s.x + alpha * s.p
        r = s.r - alpha * Ap
        rs_new = _sdot(r, r)
        p = r + (rs_new / s.rs) * s.p
        return CGState(x=x, r=r, p=p, rs=rs_new, it=s.it + 1)

    init = CGState(x=x0, r=r0, p=r0, rs=rs0, it=jnp.zeros((), jnp.int32))
    out = jax.lax.while_loop(cond, body, init)
    return out.x, out.it, out.rs


@partial(jax.jit, static_argnames=("matvec", "n_iter"))
def jacobi(matvec: Callable, diag, b, x0=None, n_iter: int = 100,
           omega: float = 1.0):
    """Weighted Jacobi smoother: x += omega * (b - A x) / diag."""
    x0 = jnp.zeros_like(b) if x0 is None else x0
    inv_d = jnp.asarray(omega, b.dtype) / diag

    def body(_, x):
        return x + inv_d * (b - matvec(x))

    return jax.lax.fori_loop(0, n_iter, body, x0)


@partial(jax.jit, static_argnames=("matvec", "max_iter"))
def pcg(matvec: Callable, diag, b, x0=None, tol: float = 1e-6,
        max_iter: int = 1000):
    """Jacobi-preconditioned CG (M = diag(A)). Returns (x, iters, res2).

    The standard pairing for the Poisson/FEM systems this library targets:
    costs one elementwise divide per iteration and typically halves the
    iteration count on stiff diagonals.
    """
    x0 = jnp.zeros_like(b) if x0 is None else x0
    inv_d = 1.0 / diag
    r0 = b - matvec(x0)
    z0 = inv_d * r0
    rz0 = _sdot(r0, z0)
    tol2 = jnp.asarray(tol, b.dtype) ** 2 * jnp.maximum(
        _sdot(b, b), jnp.ones((), b.dtype)
    )

    def cond(s):
        x, r, z, p, rz, rr, it = s
        return (rr > tol2) & (it < max_iter)

    def body(s):
        x, r, z, p, rz, rr, it = s
        Ap = matvec(p)
        alpha = rz / _sdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_d * r
        rz_new = _sdot(r, z)
        p = z + (rz_new / rz) * p
        return (x, r, z, p, rz_new, _sdot(r, r), it + 1)

    init = (x0, r0, z0, z0, rz0, _sdot(r0, r0),
            jnp.zeros((), jnp.int32))
    x, r, z, p, rz, rr, it = jax.lax.while_loop(cond, body, init)
    return x, it, rr


@partial(jax.jit, static_argnames=("matvec", "minv", "max_iter"))
def pcg_op(matvec: Callable, minv: Callable, b, x0=None, tol: float = 1e-6,
           max_iter: int = 1000):
    """CG with an arbitrary SPD preconditioner OPERATOR z = minv(r) —
    the generalization of pcg's diagonal M (used with the AMG V-cycle,
    ops/multigrid_sbell.py). Returns (x, iters, res2)."""
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    z0 = minv(r0)
    rz0 = _sdot(r0, z0)
    tol2 = jnp.asarray(tol, b.dtype) ** 2 * jnp.maximum(
        _sdot(b, b), jnp.ones((), b.dtype)
    )

    def cond(s):
        x, r, z, p, rz, rr, it = s
        return (rr > tol2) & (it < max_iter)

    def body(s):
        x, r, z, p, rz, rr, it = s
        Ap = matvec(p)
        alpha = rz / _sdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = minv(r)
        rz_new = _sdot(r, z)
        p = z + (rz_new / rz) * p
        return (x, r, z, p, rz_new, _sdot(r, r), it + 1)

    init = (x0, r0, z0, z0, rz0, _sdot(r0, r0),
            jnp.zeros((), jnp.int32))
    x, r, z, p, rz, rr, it = jax.lax.while_loop(cond, body, init)
    return x, it, rr


@partial(jax.jit, static_argnames=("matvec", "max_iter"))
def bicgstab(matvec: Callable, b, x0=None, tol: float = 1e-6,
             max_iter: int = 1000):
    """BiCGSTAB for general (nonsymmetric) systems. Returns (x, iters, res2).

    Same compile-once lax.while_loop discipline as cg; breakdown
    (rho ≈ 0) exits early via the residual test.
    """
    x0 = jnp.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    rhat = r0
    tol2 = jnp.asarray(tol, b.dtype) ** 2 * jnp.maximum(
        _sdot(b, b), jnp.ones((), b.dtype)
    )
    eps = jnp.asarray(1e-30, b.dtype)

    def cond(s):
        x, r, p, v, rho, alpha, omega, rr, it = s
        return (rr > tol2) & (it < max_iter)

    def body(s):
        x, r, p, v, rho, alpha, omega, rr, it = s
        rho_new = _sdot(rhat, r)
        beta = (rho_new / jnp.where(jnp.abs(rho) > eps, rho, eps)) * (
            alpha / jnp.where(jnp.abs(omega) > eps, omega, eps)
        )
        p = r + beta * (p - omega * v)
        v = matvec(p)
        alpha = rho_new / jnp.where(
            jnp.abs(_sdot(rhat, v)) > eps, _sdot(rhat, v), eps
        )
        s_vec = r - alpha * v
        t = matvec(s_vec)
        tt = _sdot(t, t)
        omega = _sdot(t, s_vec) / jnp.where(tt > eps, tt, eps)
        x = x + alpha * p + omega * s_vec
        r = s_vec - omega * t
        return (x, r, p, v, rho_new, alpha, omega, _sdot(r, r), it + 1)

    one = jnp.ones((), b.dtype)
    init = (x0, r0, jnp.zeros_like(b), jnp.zeros_like(b), one, one, one,
            _sdot(r0, r0), jnp.zeros((), jnp.int32))
    x, r, p, v, rho, alpha, omega, rr, it = jax.lax.while_loop(
        cond, body, init)
    return x, it, rr
