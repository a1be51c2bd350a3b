#!/usr/bin/env python
"""Bring-up smoke of the sparse-solve path on CUDA GPUs.

Drives the library through the entry points a user calls (auto_format,
the solvers, sort, SpMM/SpGEMM, the distributed operators) at the sizes
its users run, checks every result against scipy/numpy in float64, and
times the hand-written SBELL SpMV kernel against the plain XLA form.

    python chip_smoke.py                # phases 1-8 on one GPU
    python chip_smoke.py --four-cards   # the distributed phase, 4 GPUs
    python chip_smoke.py --rehearse     # tiny sizes on the CPU: plumbing
                                        # only, prints no result line

Run from the repository root. One process drives the card(s); the
nvidia-smi query runs in a child process that never imports JAX. Every
line before the last names the card and its power limit; the last line
is {"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
Any failed check raises, and the script exits non-zero.

Tolerance rule for float32 results: max|y - y_ref| <= 1e-5 *
max_i (|A| @ |x|)_i against a float64 reference — loose enough for the
card's summation order, about 50x too tight for a TF32 product.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import sys
import time
from functools import lru_cache, partial

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

L2_BYTES = 50 * 1024 * 1024        # H100/H200 L2 (NVIDIA data sheet)
REL_TOL = 1e-5

FULL = dict(cant="cant", pwtk="pwtk", big=260_000, dia_grid=3072,
            ell_rows=1 << 20, cg_grid=1024, amg_brows=20_000,
            sort_n=500_000_000, argsort_n=100_000_000, spmm_k=64,
            p4_grid=4096, blur_n=16384,
            chain={"cant": 1000, "pwtk": 400, "big": 60})
REHEARSE = dict(cant=400, pwtk=600, big=3_000, dia_grid=96,
                ell_rows=5_000, cg_grid=64, amg_brows=500,
                sort_n=1 << 20, argsort_n=1 << 18, spmm_k=64,
                p4_grid=128, blur_n=512,
                chain={"cant": 3, "pwtk": 3, "big": 3})

CARD = "unknown card"
RESULTS: dict = {}


def say(phase: str, **fields):
    print(json.dumps({"phase": phase, "card": CARD, **fields},
                     default=lambda v: v.item() if hasattr(v, "item")
                     else str(v)), flush=True)


def need(cond, what: str):
    if not cond:
        raise AssertionError(f"check failed: {what}")


def bound(A, x):
    """The tolerance rule's bound for y = A @ x (x vector or matrix)."""
    import numpy as np

    return REL_TOL * float(np.max(abs(A) @ np.abs(x.astype(np.float64))))


def quantized(A):
    """A with its values rounded to bf16 (the bf16 operator's oracle)."""
    import jax.numpy as jnp
    import numpy as np

    Aq = A.copy()
    Aq.data = np.asarray(jnp.asarray(A.data).astype(jnp.bfloat16)
                         .astype(jnp.float32))
    return Aq


@lru_cache(maxsize=None)
def host_matrix(name: str, size):
    """Host scipy operators, built once per process (seeded)."""
    from libhpc_tpu.bench import matrices

    if name == "cant":
        return (matrices.cant_like() if size == "cant" else
                matrices.block_random(size, blocks_per_row=8, half_band=6,
                                      seed=1))
    if name == "pwtk":
        return (matrices.pwtk_like() if size == "pwtk" else
                matrices.block_random(size, blocks_per_row=7, half_band=40,
                                      seed=2))
    if name == "big":   # the 100M-nnz-class block operator
        return matrices.block_random_fast(size, blocks_per_row=8,
                                          half_band=6, far_fraction=0.01,
                                          seed=3)
    raise KeyError(name)


def chain_time(f, op, x0, n: int, reps: int = 5) -> float:
    """Median seconds per f(op, .) over a jitted chain of n applications,
    host clock around block_until_ready, after a warm-up run; op is a
    jit operand (never a compile-time constant)."""
    import jax

    g = jax.jit(lambda op, x: jax.lax.fori_loop(
        0, n, lambda i, v: f(op, v), x))
    g(op, x0).block_until_ready()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        g(op, x0).block_until_ready()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2] / n


def cg_solve(c, b, mv, max_iter):
    import jax

    from libhpc_tpu.ops import solver

    @jax.jit
    def run(c, b):
        return solver.cg(partial(mv, c), b, tol=1e-6, max_iter=max_iter)

    return run, run(c, b)


def rel_residual(A, x, b) -> float:
    import numpy as np

    r = b.astype(np.float64) - A.astype(np.float64) @ np.asarray(
        x, np.float64)
    return float(np.linalg.norm(r) / np.linalg.norm(b))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(rehearse: bool):
    import jax
    import jaxlib

    from libhpc_tpu.utils.cache import enable_compilation_cache

    dev = jax.devices()[0]
    if not rehearse:
        need(dev.platform == "gpu",
             f"a CUDA GPU (JAX's default device is {dev.platform})")
    cache = enable_compilation_cache()
    print(CARD, flush=True)
    say("1-device", platform=dev.platform, kind=dev.device_kind,
        count=len(jax.devices()), jax=jax.__version__,
        jaxlib=jaxlib.__version__, xla_flags=os.environ.get("XLA_FLAGS", ""),
        compile_cache=cache)


def phase_spmv(S):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libhpc_tpu.ops.spmv_pallas import default_impl
    from libhpc_tpu.sparse.auto import auto_format
    from libhpc_tpu.sparse.sbell import SBELL

    rng = np.random.default_rng(0)
    for name in ("cant", "pwtk", "big"):
        A = host_matrix(name, S[name])
        x = rng.standard_normal(A.shape[1]).astype(np.float32)
        for bf16 in ((False, True) if name != "big" else (False,)):
            t0 = time.perf_counter()
            c, mv = auto_format(A, prefer_bf16=bf16)
            t_setup = time.perf_counter() - t0
            need(isinstance(c, SBELL), f"{name}: SBELL route")
            Ar = quantized(A) if bf16 else A
            y = np.asarray(jax.block_until_ready(mv(c, jnp.asarray(x))))
            err = float(np.abs(y - Ar.astype(np.float64) @ x).max())
            bd = bound(Ar, x)
            say("2-spmv", matrix=name, dtype="bf16" if bf16 else "f32",
                route=type(c).__name__, impl=default_impl(),
                rows=A.shape[0], nnz=A.nnz, n_tiles=c.n_tiles,
                n_far=c.far.n_far if c.far is not None else 0,
                operand_bytes=c.hbm_bytes, l2_bytes=L2_BYTES,
                fits_l2=c.hbm_bytes <= L2_BYTES, max_err=err, bound=bd,
                host_setup_s=t_setup)
            need(err <= bd, f"{name} spmv within the tolerance rule")
            del c, y


def phase_routes(S):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libhpc_tpu.bench import matrices
    from libhpc_tpu.sparse.auto import auto_format
    from libhpc_tpu.sparse.dia import DIA
    from libhpc_tpu.sparse.ell import ELL

    rng = np.random.default_rng(1)
    for label, A, kind in (
            ("dia_poisson", matrices.poisson2d(S["dia_grid"]), DIA),
            ("ell_irregular_band",
             matrices.irregular_band(S["ell_rows"]), ELL)):
        x = rng.standard_normal(A.shape[1]).astype(np.float32)
        t0 = time.perf_counter()
        c, mv = auto_format(A)
        t_setup = time.perf_counter() - t0
        need(isinstance(c, kind), f"{label}: {kind.__name__} route")
        y = np.asarray(jax.block_until_ready(mv(c, jnp.asarray(x))))
        err = float(np.abs(y - A.astype(np.float64) @ x).max())
        bd = bound(A, x)
        nbytes = sum(a.nbytes for a in jax.tree_util.tree_leaves(c))
        say("3-routes", case=label, route=kind.__name__, rows=A.shape[0],
            nnz=A.nnz, operand_bytes=nbytes, l2_bytes=L2_BYTES,
            max_err=err, bound=bd, host_setup_s=t_setup)
        need(err <= bd, f"{label} within the tolerance rule")
        del c, y


def phase_solvers(S):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sps

    from libhpc_tpu.bench import matrices
    from libhpc_tpu.ops import multigrid_sbell as amg
    from libhpc_tpu.ops.spmv_pallas import sbell_spmv
    from libhpc_tpu.sparse.auto import auto_format

    rng = np.random.default_rng(2)
    cases = (
        ("cg_pwtk_spd", lambda: matrices.spd_from(
            host_matrix("pwtk", S["pwtk"]))),
        ("cg_poisson_shifted", lambda: (
            matrices.poisson2d(S["cg_grid"])
            + 0.5 * sps.eye(S["cg_grid"] ** 2)).tocsr().astype(np.float32)),
    )
    for label, make in cases:
        A = make()
        b = rng.standard_normal(A.shape[0]).astype(np.float32)
        t0 = time.perf_counter()
        c, mv = auto_format(A)
        t_setup = time.perf_counter() - t0
        run, (x, it, _) = cg_solve(c, jnp.asarray(b), mv, 5000)
        x = np.asarray(jax.block_until_ready(x))
        t0 = time.perf_counter()
        jax.block_until_ready(run(c, jnp.asarray(b)))
        t_solve = time.perf_counter() - t0
        res = rel_residual(A, x, b)
        if label == "cg_pwtk_spd":
            ma = run.lower(c, jnp.asarray(b)).compile().memory_analysis()
            RESULTS["cg_memory_analysis"] = {
                k: getattr(ma, k) for k in (
                    "argument_size_in_bytes", "output_size_in_bytes",
                    "temp_size_in_bytes", "alias_size_in_bytes",
                    "generated_code_size_in_bytes") if hasattr(ma, k)}
        say("4-solvers", case=label, route=type(c).__name__,
            rows=A.shape[0], nnz=A.nnz, iterations=int(it),
            true_rel_residual=res, solve_s=t_solve, host_setup_s=t_setup)
        need(res <= 1e-5, f"{label} true residual <= 1e-5")
        del c, run

    A = matrices.spd_fem(S["amg_brows"])
    b = rng.standard_normal(A.shape[0]).astype(np.float32)
    t0 = time.perf_counter()
    H = amg.amg_setup(A, n_levels=3)
    t_setup = time.perf_counter() - t0
    need(H.levels, "AMG built at least one level")

    @jax.jit
    def amg_run(H, b):
        sb = H.levels[0].sbell
        return amg.amg_pcg(H, lambda v: sbell_spmv(sb, v), b, tol=1e-6)

    x, it, _ = amg_run(H, jnp.asarray(b))
    x = np.asarray(jax.block_until_ready(x))
    t0 = time.perf_counter()
    jax.block_until_ready(amg_run(H, jnp.asarray(b)))
    t_solve = time.perf_counter() - t0
    res = rel_residual(A, x, b)
    say("4-solvers", case="amg_pcg_spd_fem", rows=A.shape[0], nnz=A.nnz,
        levels=len(H.levels) + 1, iterations=int(it),
        true_rel_residual=res, solve_s=t_solve,
        host_setup_s=t_setup)
    need(res <= 1e-5, "AMG-PCG true residual <= 1e-5")


def phase_sort(S):
    import jax
    import jax.numpy as jnp

    from libhpc_tpu.ops.sort import argsort_u32, sort_u32

    n = S["sort_n"]
    xs = jax.jit(lambda k: jax.random.bits(k, (n,), jnp.uint32))(
        jax.random.key(0))

    def halves(v):
        return (jnp.sum(v & jnp.uint32(0xFFFF)), jnp.sum(v >> jnp.uint32(16)))

    out = jax.block_until_ready(sort_u32(xs))
    ok_sorted = bool(jnp.all(out[1:] >= out[:-1]))
    ok_sum = all(bool(a == b) for a, b in zip(halves(out), halves(xs)))
    del out
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        sort_u32(xs).block_until_ready()
        ts.append(time.perf_counter() - t0)
    t = sorted(ts)[1]
    say("5-sort", op="sort_u32", n=n, sorted=ok_sorted,
        checksums_match=ok_sum, seconds=t, g_keys_per_s=n / t / 1e9)
    need(ok_sorted and ok_sum, "sort_u32 exact")
    del xs

    n = S["argsort_n"]
    keys = jax.jit(lambda k: jax.random.bits(k, (n,), jnp.uint32))(
        jax.random.key(1))

    @jax.jit
    def verify(keys, s, order):
        in_order = jnp.all(s[1:] >= s[:-1])
        gathered = jnp.all(keys[order] == s)
        stable = jnp.all((s[1:] != s[:-1]) | (order[1:] > order[:-1]))
        perm = jnp.all(jnp.zeros(n, jnp.int32).at[order].add(1) == 1)
        ties = jnp.sum(s[1:] == s[:-1])
        return in_order, gathered, stable, perm, ties

    s, order = jax.block_until_ready(argsort_u32(keys))
    in_order, gathered, stable, perm, ties = (
        v.item() for v in verify(keys, s, order))
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(argsort_u32(keys))
        ts.append(time.perf_counter() - t0)
    t = sorted(ts)[1]
    say("5-sort", op="argsort_u32", n=n, sorted=in_order,
        keys_match=gathered, stable=stable, permutation=perm,
        equal_key_pairs=ties, seconds=t, g_keys_per_s=n / t / 1e9)
    need(in_order and gathered and stable and perm, "argsort exact+stable")


def phase_spmm_spgemm(S):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sps

    from libhpc_tpu.ops import spgemm_bsr as sgb
    from libhpc_tpu.ops.spmm import bsr_spmm
    from libhpc_tpu.sparse import BSR

    A = host_matrix("cant", S["cant"])
    bsr = BSR.from_scipy(A, block=8)
    X = np.random.default_rng(3).standard_normal(
        (bsr.shape[1], S["spmm_k"])).astype(np.float32)
    Y = np.asarray(jax.block_until_ready(bsr_spmm(bsr, jnp.asarray(X))))
    Ap = A.copy()
    Ap.resize(bsr.shape)
    err = float(np.abs(Y - Ap.astype(np.float64) @ X).max())
    bd = bound(Ap, X)
    say("6-spmm", op="bsr_spmm", matrix="cant", k=S["spmm_k"],
        max_err=err, bound=bd)
    need(err <= bd, "bsr_spmm within the tolerance rule")
    del bsr, Y

    A = host_matrix("pwtk", S["pwtk"])
    Ab = BSR.from_scipy(A, block=8)
    ai = np.asarray(Ab.indices, np.int64)
    ap = np.asarray(Ab.indptr, np.int64)
    t0 = time.perf_counter()
    pairs = sgb._symbolic(ai, ap, ai, ap, Ab.shape[1] // 8)[0].size
    t_sym = time.perf_counter() - t0
    t0 = time.perf_counter()
    C = sgb.spgemm_bsr(Ab, Ab)
    jax.block_until_ready(C.indices)
    t_all = time.perf_counter() - t0
    got = C.to_scipy().tocsr()
    got.eliminate_zeros()
    ref = (sps.csr_matrix(Ab.to_scipy()) ** 2).tocsr()
    ref.eliminate_zeros()
    d = got - ref
    dmax = float(abs(d).max()) if d.nnz else 0.0
    say("6-spgemm", op="spgemm_bsr", matrix="pwtk", block_pairs=pairs,
        nnz_c=ref.nnz, max_abs_err=dmax, limit=1e-2,
        host_symbolic_s=t_sym, total_s=t_all)
    need(dmax < 1e-2, "spgemm_bsr matches scipy")


def phase_kernel_vs_xla(S, interpret: bool):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from libhpc_tpu.ops import spmv
    from libhpc_tpu.ops.spmv_pallas import sbell_spmv_panes, x_to_panes
    from libhpc_tpu.sparse.bell import BELL
    from libhpc_tpu.sparse.sbell import SBELL

    for name in ("cant", "pwtk", "big"):
        A = host_matrix(name, S[name])
        n = A.shape[1]
        scale = 1.0 / float(abs(A).sum(axis=1).max())
        sb = SBELL.from_scipy(A)
        x = np.random.default_rng(4).standard_normal(n).astype(np.float32)
        for dtype in ("f32", "bf16"):
            sbv = sb if dtype == "f32" else sb.astype_values(jnp.bfloat16)
            x3 = x_to_panes(sbv, jnp.pad(jnp.asarray(x),
                                         (0, sbv.n_panes * 1024 - n)))
            us = {}
            for impl in ("kernel", "xla"):
                kw = dict(impl=impl, interpret=interpret and
                          impl == "kernel")
                us[impl] = 1e6 * chain_time(
                    lambda op, v, kw=kw: sbell_spmv_panes(op, v, **kw)
                    * scale, sbv, x3, S["chain"][name])
            if dtype == "f32" and name != "big":
                bell = BELL.from_scipy(A)
                xb = jnp.pad(jnp.asarray(x), (0, bell.shape[1] - n))
                us["bell_xla"] = 1e6 * chain_time(
                    lambda op, v: spmv.bell_spmv(op, v) * scale, bell, xb,
                    S["chain"][name])
                del bell
            say("7-kernel-vs-xla", matrix=name, dtype=dtype,
                operand_bytes=sbv.hbm_bytes, us_per_matvec=us,
                kernel_speedup_vs_xla=us["xla"] / us["kernel"],
                kernel_gb_per_s=sbv.hbm_bytes / us["kernel"] / 1e3,
                timing="median of 5 jitted chains, host clock")
            del sbv, x3
        del sb
    stats = jax.devices()[0].memory_stats() or {}
    say("7-kernel-vs-xla", cg_step_memory_analysis=RESULTS.get(
        "cg_memory_analysis"), peak_bytes_in_use=stats.get(
        "peak_bytes_in_use"))


def phase_gpu_tests(rehearse: bool):
    import pytest

    os.environ["LIBHPC_TEST_GPU"] = "1"
    counts = {"passed": 0, "failed": 0, "skipped": 0}

    class Count:
        def pytest_runtest_logreport(self, report):
            if report.when == "call" or report.outcome != "passed":
                counts[report.outcome] = counts.get(report.outcome, 0) + 1

    out = io.StringIO()     # pytest's own lines would not name the card
    with contextlib.redirect_stdout(out):
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          "-p", "no:randomly",
                          os.path.join(ROOT, "tests", "test_gpu.py")],
                         plugins=[Count()])
    if int(rc) != 0:
        print(out.getvalue(), file=sys.stderr, flush=True)
    summary = (out.getvalue().strip().splitlines() or [""])[-1]
    say("8-gpu-tests", exit_code=int(rc), summary=summary, **counts)
    need(int(rc) == 0, "gpu-marked tests pass")
    if not rehearse:
        need(counts["passed"] > 0 and counts["skipped"] == 0,
             "gpu-marked tests ran")


def phase_four_cards(S, rehearse: bool):
    """The distributed operators on a mesh of 4, each compared in this
    process with the one-card result on device 0."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sps
    from jax.sharding import NamedSharding, PartitionSpec as P

    from libhpc_tpu.bench import matrices
    from libhpc_tpu.ops import stencil
    from libhpc_tpu.ops.spmv import csr_spmv, dia_spmv
    from libhpc_tpu.ops.spmv_pallas import sbell_spmv
    from libhpc_tpu.parallel.dist2d import Dist2DCSR, dist2d_spmv_fn
    from libhpc_tpu.parallel.dist_amg import dist_amg_pcg
    from libhpc_tpu.parallel.dist_dia import DistDIA, dist_dia_spmv_fn
    from libhpc_tpu.parallel.dist_sbell import DistSBELL, dist_sbell_spmv_fn
    from libhpc_tpu.parallel.dist_spmv import DistCSR, dist_cg
    from libhpc_tpu.parallel.dist_stencil import dist_blur2d_fn
    from libhpc_tpu.parallel.mesh import make_mesh_1d
    from libhpc_tpu.sparse import CSR, DIA
    from libhpc_tpu.sparse.sbell import SBELL

    devs = jax.devices()
    need(len(devs) >= 4, f"4 devices (found {len(devs)})")
    if not rehearse:
        need(devs[0].platform == "gpu", "CUDA GPUs")
    mesh = make_mesh_1d(4)
    row = NamedSharding(mesh, P("x"))
    rng = np.random.default_rng(5)

    def on_d0(tree):
        return jax.device_put(tree, devs[0])

    def compare(label, y_dist, y_one, A, x, **extra):
        err = float(np.abs(np.asarray(y_dist)[:A.shape[0]]
                           - np.asarray(y_one)[:A.shape[0]]).max())
        bd = bound(A, x)
        say("4cards", case=label, rows=A.shape[0], nnz=A.nnz, max_diff=err,
            bound=bd, **extra)
        need(err <= bd, f"{label}: 4 cards vs 1 card within the rule")

    # --- DistCSR CG and DistDIA SpMV on Poisson (16.8M rows) -------------
    g = S["p4_grid"]
    Pn = matrices.poisson2d(g)
    A = (Pn + 0.5 * sps.eye(g * g)).tocsr().astype(np.float32)
    b = rng.standard_normal(A.shape[0]).astype(np.float32)
    t0 = time.perf_counter()
    dA = DistCSR.from_scipy(A, 4).shard(mesh)
    t_setup = time.perf_counter() - t0
    xd, itd, _ = dist_cg(dA, jax.device_put(jnp.asarray(b), row), mesh,
                         tol=1e-6, max_iter=5000)
    _, (x1, it1, _) = cg_solve(on_d0(CSR.from_scipy(A)),
                               on_d0(jnp.asarray(b)), csr_spmv, 5000)
    res_d = rel_residual(A, np.asarray(xd)[:A.shape[0]], b)
    res_1 = rel_residual(A, np.asarray(x1), b)
    sol_diff = float(np.abs(np.asarray(xd)[:A.shape[0]]
                            - np.asarray(x1)).max()
                     / np.abs(np.asarray(x1)).max())
    say("4cards", case="distcsr_cg_poisson_shifted", rows=A.shape[0],
        nnz=A.nnz, iterations_4=int(itd), iterations_1=int(it1),
        true_rel_residual_4=res_d, true_rel_residual_1=res_1,
        rel_solution_diff=sol_diff, host_setup_s=t_setup)
    need(abs(int(itd) - int(it1)) <= 2, "CG iterations agree within 2")
    need(res_d <= 1e-5 and res_1 <= 1e-5, "CG residuals <= 1e-5")
    need(sol_diff <= 1e-4, "CG solutions agree")
    del dA, xd, x1

    x = rng.standard_normal(Pn.shape[1]).astype(np.float32)
    dD = DistDIA.from_scipy(Pn, 4).shard(mesh)
    y4 = dist_dia_spmv_fn(dD, mesh)(jax.device_put(jnp.asarray(x), row))
    y1 = dia_spmv(on_d0(DIA.from_scipy(Pn)), on_d0(jnp.asarray(x)))
    compare("distdia_spmv_poisson", y4, y1, Pn, x)
    del dD, y4, y1

    # --- Dist2DCSR on a 2x2 mesh -----------------------------------------
    mesh2 = jax.make_mesh((2, 2), ("py", "px"), devices=devs[:4])
    d2 = Dist2DCSR.from_scipy(Pn, (2, 2)).shard(mesh2)
    y4 = dist2d_spmv_fn(d2, mesh2)(jax.device_put(
        jnp.asarray(x), NamedSharding(mesh2, P("px"))))
    y1 = csr_spmv(on_d0(CSR.from_scipy(Pn)), on_d0(jnp.asarray(x)))
    compare("dist2dcsr_spmv_poisson_2x2", y4, y1, Pn, x)
    del d2, y4, y1

    # --- DistSBELL on the 100M-nnz-class operator ------------------------
    A = host_matrix("big", S["big"])
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    t0 = time.perf_counter()
    dS = DistSBELL.from_scipy(A, 4).shard(mesh)
    t_setup = time.perf_counter() - t0
    xp = np.zeros(dS.shape[1], np.float32)
    xp[:A.shape[1]] = x
    y4 = dist_sbell_spmv_fn(dS, mesh)(jax.device_put(jnp.asarray(xp), row))
    y1 = sbell_spmv(on_d0(SBELL.from_scipy(A)), on_d0(jnp.asarray(x)))
    compare("distsbell_spmv_100m", y4, y1, A, x, host_setup_s=t_setup)
    del dS, y4, y1

    # --- distributed AMG-PCG vs the same solver on one card --------------
    A = matrices.spd_fem(S["amg_brows"])
    b = rng.standard_normal(A.shape[0]).astype(np.float32)
    x4, it4, _ = dist_amg_pcg(A, mesh, 4, b, tol=1e-6)
    x1, it1, _ = dist_amg_pcg(A, make_mesh_1d(1), 1, b, tol=1e-6)
    res4 = rel_residual(A, np.asarray(x4)[:A.shape[0]], b)
    res1 = rel_residual(A, np.asarray(x1)[:A.shape[0]], b)
    say("4cards", case="dist_amg_pcg_spd_fem", rows=A.shape[0], nnz=A.nnz,
        iterations_4=int(it4), iterations_1=int(it1),
        true_rel_residual_4=res4, true_rel_residual_1=res1)
    need(abs(int(it4) - int(it1)) <= 2, "AMG-PCG iterations agree within 2")
    need(res4 <= 1e-5 and res1 <= 1e-5, "AMG-PCG residuals <= 1e-5")
    del x4, x1

    # --- halo-overlapped box blur, radius 8 ------------------------------
    n = S["blur_n"]
    a1 = on_d0(jax.jit(lambda k: jax.random.normal(k, (n, n),
                                                   jnp.float32))(
        jax.random.key(6)))
    y1 = stencil.blur2d(a1, 8)
    bd = REL_TOL * float(jnp.max(stencil.blur2d(jnp.abs(a1), 8)))
    y4 = dist_blur2d_fn(mesh, radius=8, overlap=True)(
        jax.device_put(a1, row))
    err = float(jnp.max(jnp.abs(jax.device_put(y4, devs[0]) - y1)))
    say("4cards", case="dist_blur2d_overlap_r8", shape=[n, n],
        max_diff=err, bound=bd)
    need(err <= bd, "blur: 4 cards vs 1 card within the rule")


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed phase, on 4 GPUs")
    ap.add_argument("--rehearse", action="store_true",
                    help="tiny sizes on the CPU; prints no result line")
    args = ap.parse_args(argv)

    import jax

    if args.rehearse:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 4)
        CARD = "cpu rehearsal (no GPU)"
    else:
        from libhpc_tpu.bench.harness import card

        CARD = card() or "no nvidia-smi"
    S = REHEARSE if args.rehearse else FULL
    t_start = time.perf_counter()

    phase_device(args.rehearse)
    if args.four_cards:
        phase_four_cards(S, args.rehearse)
        count = 4
    else:
        for phase in (phase_spmv, phase_routes, phase_solvers, phase_sort,
                      phase_spmm_spgemm):
            phase(S)
            gc.collect()
        phase_kernel_vs_xla(S, interpret=args.rehearse)
        gc.collect()
        phase_gpu_tests(args.rehearse)
        count = 1
    say("done", seconds=time.perf_counter() - t_start)
    if args.rehearse:
        print("rehearsal ok (no result line off the GPU)", flush=True)
        return 0
    dev = jax.devices()[0]
    need(len(jax.devices()) >= count, f"{count} devices")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
