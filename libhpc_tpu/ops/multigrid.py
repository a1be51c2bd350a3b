"""Geometric multigrid (V-cycle) for the 2D Poisson model problem.

The flagship composite workload: weighted-Jacobi smoothing, 5-point
matrix-free operator (zero-gather stencil, ops.stencil), full-weighting
restriction and bilinear prolongation (static strided slices — no gather),
recursion unrolled at trace time into one XLA program.

Vertex-centered hierarchy: interior grids of size n = 2^k - 1, coarse point
(i, j) sits at fine (2i+1, 2j+1). Operator A_h = (4u - Σ neighbors) / h²
with Dirichlet zero boundary — matches
libhpc_tpu.bench.matrices.poisson2d(n) scaled by 1/h².
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


def poisson_op(u, h: float):
    """A_h u for the 5-point Laplacian on spacing h (zero Dirichlet)."""
    up = jnp.pad(u, 1)
    return (
        4.0 * u
        - up[:-2, 1:-1]
        - up[2:, 1:-1]
        - up[1:-1, :-2]
        - up[1:-1, 2:]
    ) / (h * h)


def restrict_fw(r):
    """Full-weighting restriction (2m+1)² → m²."""
    c = r[1::2, 1::2]
    n_ = r[0:-1:2, 1::2]
    s_ = r[2::2, 1::2]
    w_ = r[1::2, 0:-1:2]
    e_ = r[1::2, 2::2]
    nw = r[0:-1:2, 0:-1:2]
    ne = r[0:-1:2, 2::2]
    sw = r[2::2, 0:-1:2]
    se = r[2::2, 2::2]
    return (4.0 * c + 2.0 * (n_ + s_ + w_ + e_) + (nw + ne + sw + se)) / 16.0


def prolong_bilinear(e):
    """Bilinear prolongation m² → (2m+1)² (zero Dirichlet halo)."""
    m = e.shape[0]
    n = 2 * m + 1
    ep = jnp.pad(e, 1)  # (m+2, m+2), zero boundary
    out = jnp.zeros((n, n), e.dtype)
    out = out.at[1::2, 1::2].set(e)
    # edge midpoints between vertically adjacent coarse points
    vert = 0.5 * (ep[:-1, 1:-1] + ep[1:, 1:-1])    # (m+1, m)
    out = out.at[0::2, 1::2].set(vert)
    horiz = 0.5 * (ep[1:-1, :-1] + ep[1:-1, 1:])   # (m, m+1)
    out = out.at[1::2, 0::2].set(horiz)
    # face centers: average of 4 coarse neighbors
    quad = 0.25 * (ep[:-1, :-1] + ep[:-1, 1:] + ep[1:, :-1] + ep[1:, 1:])
    out = out.at[0::2, 0::2].set(quad)
    return out


def smooth_jacobi(u, f, h: float, n_iter: int, omega: float = 0.8):
    inv_d = omega * (h * h) / 4.0

    def body(_, u):
        return u + inv_d * (f - poisson_op(u, h))

    return jax.lax.fori_loop(0, n_iter, body, u)


def v_cycle(u, f, h: float, pre: int = 2, post: int = 2,
            coarse_iters: int = 32):
    """One V-cycle; recursion unrolled at trace time down to a 1-3 point
    coarsest grid solved by smoothing."""
    n = u.shape[0]
    if n <= 3:
        return smooth_jacobi(u, f, h, coarse_iters)
    u = smooth_jacobi(u, f, h, pre)
    r = f - poisson_op(u, h)
    rc = restrict_fw(r)
    ec = v_cycle(jnp.zeros_like(rc), rc, 2.0 * h, pre, post, coarse_iters)
    u = u + prolong_bilinear(ec)
    return smooth_jacobi(u, f, h, post)


@partial(jax.jit, static_argnames=("h", "n_cycles", "pre", "post"))
def mg_solve(f, h: float = 1.0, n_cycles: int = 10, pre: int = 2,
             post: int = 2):
    """n_cycles V-cycles from a zero initial guess. Returns (u, res_norm)."""
    u = jnp.zeros_like(f)

    def body(_, u):
        return v_cycle(u, f, h, pre, post)

    u = jax.lax.fori_loop(0, n_cycles, body, u)
    res = f - poisson_op(u, h)
    return u, jnp.sqrt(jnp.sum(res * res))


# ---------------------------------------------------------------------------
# Cell-centered hierarchy (2^k grids) — every level divides evenly, so the
# whole V-cycle runs under GSPMD sharding (leading axis over the mesh) with
# XLA inserting the halo exchanges; no odd-size special cases.
# ---------------------------------------------------------------------------


def poisson_op_cc(u, h: float):
    """Cell-centered 5-point Laplacian with *reflective* ghost cells
    (u_ghost = -u_edge ⇒ homogeneous Dirichlet on the cell faces). Keeping
    the boundary on the faces makes every coarse level discretize the same
    problem — the fix for the cell-centered MG boundary-layer stall."""
    up = jnp.pad(u, 1)
    up = up.at[0, 1:-1].set(-u[0, :])
    up = up.at[-1, 1:-1].set(-u[-1, :])
    up = up.at[1:-1, 0].set(-u[:, 0])
    up = up.at[1:-1, -1].set(-u[:, -1])
    return (
        4.0 * u
        - up[:-2, 1:-1]
        - up[2:, 1:-1]
        - up[1:-1, :-2]
        - up[1:-1, 2:]
    ) / (h * h)


def _diag_cc(n, h, dtype):
    """Diagonal of poisson_op_cc: 4 + (#boundary faces) per cell, / h²."""
    d = jnp.full((n, n), 4.0, dtype)
    d = d.at[0, :].add(1.0).at[-1, :].add(1.0)
    d = d.at[:, 0].add(1.0).at[:, -1].add(1.0)
    return d / (h * h)


def smooth_jacobi_cc(u, f, h: float, n_iter: int, omega: float = 0.8):
    inv_d = omega / _diag_cc(u.shape[0], h, u.dtype)

    def body(_, u):
        return u + inv_d * (f - poisson_op_cc(u, h))

    return jax.lax.fori_loop(0, n_iter, body, u)


def restrict_cc(r):
    """Cell-centered restriction (2m)² → m²: (1/4)·P^T for the bilinear P
    below — a 4×4 stencil [[1,3,3,1],[3,9,9,3],[3,9,9,3],[1,3,3,1]]/64
    applied at stride 2."""
    rp = jnp.pad(r, 1)
    w = ((1.0, 3.0, 3.0, 1.0), (3.0, 9.0, 9.0, 3.0),
         (3.0, 9.0, 9.0, 3.0), (1.0, 3.0, 3.0, 1.0))
    m2 = r.shape[0]
    out = None
    for dy in range(4):
        for dx in range(4):
            sl = rp[dy : dy + m2 - 1 : 2, dx : dx + m2 - 1 : 2] \
                if False else rp[dy:dy + m2:2, dx:dx + m2:2]
            term = w[dy][dx] * sl
            out = term if out is None else out + term
    return out / 64.0


def prolong_cc(e):
    """Cell-centered bilinear prolongation m² → (2m)²: each fine cell takes
    9/16 from its coarse owner and 3/16, 3/16, 1/16 from the neighbors on
    its near side (zero ghost outside)."""
    m = e.shape[0]
    ep = jnp.pad(e, 1)
    c = ep[1:-1, 1:-1]
    out = jnp.zeros((2 * m, 2 * m), e.dtype)
    for di in (0, 1):
        vert = ep[2 * di : m + 2 * di or None, 1:-1][:m, :]
        for dj in (0, 1):
            horiz = ep[1:-1, 2 * dj : m + 2 * dj or None][:, :m]
            corner = ep[2 * di : m + 2 * di or None,
                        2 * dj : m + 2 * dj or None][:m, :m]
            plane = (9.0 * c + 3.0 * vert + 3.0 * horiz + corner) / 16.0
            out = out.at[di::2, dj::2].set(plane)
    return out


def v_cycle_cc(u, f, h: float, pre: int = 2, post: int = 2,
               coarse_iters: int = 64):
    """Cell-centered V-cycle on a 2^k grid (recursion unrolled at trace
    time; coarsest ≤ 4² solved by smoothing)."""
    n = u.shape[0]
    if n <= 4:
        return smooth_jacobi_cc(u, f, h, coarse_iters)
    u = smooth_jacobi_cc(u, f, h, pre)
    r = f - poisson_op_cc(u, h)
    rc = restrict_cc(r)
    ec = v_cycle_cc(jnp.zeros_like(rc), rc, 2.0 * h, pre, post, coarse_iters)
    u = u + prolong_cc(ec)
    return smooth_jacobi_cc(u, f, h, post)


@partial(jax.jit, static_argnames=("h", "n_cycles", "pre", "post"))
def mg_solve_cc(f, h: float = 1.0, n_cycles: int = 10, pre: int = 2,
                post: int = 2):
    """Cell-centered multigrid on a (2^k)² grid. GSPMD-friendly: jit this
    with a row-sharded `f` and every level stays evenly sharded."""
    u = jnp.zeros_like(f)

    def body(_, u):
        return v_cycle_cc(u, f, h, pre, post)

    u = jax.lax.fori_loop(0, n_cycles, body, u)
    res = f - poisson_op_cc(u, h)
    return u, jnp.sqrt(jnp.sum(res * res))
