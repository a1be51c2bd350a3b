"""Micro-benchmark corpus — the re-expression of the reference's
google-benchmark workload suite (tests/test_hpc_benchmark/
test_hpc_benchmark.cpp, SURVEY.md §2.20): stream/layout sweeps, stencil
blurs, transpose, matmul, convolution, sparse-grid particle writes, sort,
plus this build's SpMV formats.

Run:  python -m libhpc_tpu.bench.corpus [name ...]
Emits one JSON line per benchmark: {"bench": ..., "ms": ..., ...}, each
naming the device it ran on. All timings use the barrier/delta harness
(see harness.py); roofline fractions divide by the device's published
peak (harness.PEAKS).
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from libhpc_tpu.bench.harness import time_iterated


def _peak_bw():
    from libhpc_tpu.bench.harness import device_peaks

    return device_peaks(jax.devices()[0].device_kind)["hbm_bytes_per_s"]


def _emit(name: str, per_s: float, **extra):
    from libhpc_tpu.bench.harness import card

    dev = jax.devices()[0]
    d = {"bench": name, "ms": round(per_s * 1e3, 4),
         "platform": dev.platform, "kind": dev.device_kind, "card": card()}
    d.update({k: (round(v, 3) if isinstance(v, float) else v)
              for k, v in extra.items()})
    print(json.dumps(d), flush=True)


def bench_stream():
    n = 1 << 25  # 128 MB
    x = jnp.full((n,), 1.0, jnp.float32)
    per = time_iterated(lambda v: v * 1.0000001, x, iters=128, iters_small=16)
    _emit("stream_mul_128MB", per, gb_per_s=2 * n * 4 / per / 1e9)


def bench_transpose():
    x = jnp.ones((8192, 8192), jnp.float32)
    per = time_iterated(lambda v: jnp.swapaxes(v, 0, 1) + 0.0,
                        x, iters=16, iters_small=2)
    _emit("transpose_xla_8k", per, gb_per_s=2 * x.nbytes / per / 1e9)

    # Morton-order traversal transpose — the reference's libmorton variant
    # (test_hpc_benchmark.cpp:705-750): process the matrix as Z-ordered
    # 256² tiles so source and destination tiles stay cache-local.
    from libhpc_tpu.utils.morton import morton2d_decode

    T = 256
    nt = 8192 // T
    code = jnp.arange(nt * nt, dtype=jnp.uint32)
    ty, tx = morton2d_decode(code)

    def morton_transpose(v):
        tiles = v.reshape(nt, T, nt, T).transpose(0, 2, 1, 3)
        g = tiles[ty, tx]                       # Z-ordered tile stream
        gt = jnp.swapaxes(g, 1, 2)              # per-tile transpose
        out = jnp.zeros_like(tiles).at[tx, ty].set(gt)
        return out.transpose(0, 2, 1, 3).reshape(8192, 8192) + 0.0

    per = time_iterated(morton_transpose, x, iters=8, iters_small=2)
    _emit("transpose_morton_8k", per, gb_per_s=2 * x.nbytes / per / 1e9)


def bench_matmul():
    """Reference scale: 1024×1024 blocked matmul (test_hpc_benchmark.cpp:758)."""
    from libhpc_tpu.ops.matmul import matmul

    for n in (1024, 8192):
        a = jnp.ones((n, n), jnp.float32)
        # f32 at HIGHEST precision (no TF32); bf16 at the default
        per = time_iterated(lambda v: matmul(v, v) * 1e-3, a, iters=16,
                            iters_small=2)
        _emit(f"matmul_f32_{n}", per, tflops=2 * n ** 3 / per / 1e12)
        ab = a.astype(jnp.bfloat16)
        per = time_iterated(lambda v: (v @ v) * jnp.bfloat16(1e-3), ab,
                            iters=16, iters_small=2)
        _emit(f"matmul_bf16_{n}", per, tflops=2 * n ** 3 / per / 1e12)


def bench_conv():
    """Reference scale: 1024² image, 16×16 kernel (test_hpc_benchmark.cpp:793)."""
    img = jnp.ones((1, 1024, 1024, 1), jnp.float32)
    ker = jnp.ones((16, 16, 1, 1), jnp.float32)

    def conv(v):
        out = jax.lax.conv_general_dilated(
            v, ker, (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        return v * 0.5 + out * 1e-3

    per = time_iterated(conv, img, iters=8, iters_small=2)
    _emit("conv2d_1024_k16", per,
          gflops=2 * 1024 * 1024 * 256 / per / 1e9)


def bench_blur():
    """Reference scale: 8192², radius 8 (test_hpc_benchmark.cpp:29-33)."""
    from libhpc_tpu.ops.stencil import blur2d

    a = jnp.ones((8192, 8192), jnp.float32)
    per = time_iterated(lambda v: blur2d(v, 8) * 0.0588 / 17.0 + 0.0, a,
                        iters=8, iters_small=2)
    _emit("blur2d_xla_8192_r8", per, gb_per_s=2 * a.nbytes / per / 1e9)


def bench_sort():
    """Reference CPU-test scale: 10M uint32 (test_radixsort_v1.cc)."""
    from libhpc_tpu.ops.sort import sort_u32

    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.integers(0, 1 << 32, 10_000_000, dtype=np.uint32))

    def step(v):
        s = sort_u32(v)
        return jnp.roll(s, 1)  # perturb so next iteration re-sorts

    per = time_iterated(step, x, iters=8, iters_small=2)
    _emit("sort_u32_10M", per, gelem_per_s=1e7 / per / 1e9)

    n100 = 100_000_000  # reference GPU gtest e2e scale
    x100 = jnp.asarray(rng.integers(0, 1 << 32, n100, dtype=np.uint32))
    per = time_iterated(step, x100, iters=3, iters_small=1)
    _emit("sort_u32_100M", per, gelem_per_s=n100 / per / 1e9)

    # stage-parity radix path — 1M is enough to expose the scatter-bound
    # rate without a minutes-long rep
    from libhpc_tpu.ops.sort import radix_sort_pipeline

    x1 = jnp.asarray(rng.integers(0, 1 << 32, 1_000_000, dtype=np.uint32))
    per = time_iterated(lambda v: jnp.roll(radix_sort_pipeline(v), 1), x1,
                        iters=3, iters_small=1)
    _emit("radix_pipeline_1M", per, gelem_per_s=1e6 / per / 1e9)


def bench_scan_hist():
    from libhpc_tpu.ops.histogram import histogram
    from libhpc_tpu.ops.scan import exclusive_scan

    x = jnp.ones((1 << 22,), jnp.float32)
    per = time_iterated(lambda v: exclusive_scan(v) * 1e-9, x,
                        iters=8, iters_small=2)
    _emit("exclusive_scan_4M", per, gb_per_s=2 * x.nbytes / per / 1e9)

    xi = jnp.zeros((1 << 22,), jnp.int32)

    def hstep(v):
        h = histogram(v, 256)
        # (h[0] & 1) is runtime-zero but not syntactically zero, so XLA
        # cannot fold the histogram out of the loop
        return v + (h[0] & 1)

    per = time_iterated(hstep, xi, iters=8, iters_small=2)
    _emit("histogram_4M", per, gelem_per_s=(1 << 22) / per / 1e9)


def bench_spmv():
    from libhpc_tpu.bench.matrices import poisson2d
    from libhpc_tpu.sparse import CSR, ELL, DIA
    from libhpc_tpu.ops import spmv

    A = poisson2d(512)  # 262k rows, 1.3M nnz
    csr = CSR.from_scipy(A)
    nnz = A.nnz
    x = jnp.ones((A.shape[0],), jnp.float32)
    dia = DIA.from_scipy(A)
    per = time_iterated(lambda v: spmv.dia_spmv(dia, v), x, iters=32,
                        iters_small=4)
    _emit("spmv_dia_poisson512", per, gnnz_per_s=nnz / per / 1e9)
    ell = ELL.from_csr(csr)
    per = time_iterated(lambda v: spmv.ell_spmv(ell, v), x, iters=8,
                        iters_small=2)
    _emit("spmv_ell_poisson512", per, gnnz_per_s=nnz / per / 1e9)


def bench_sbell():
    """SBELL SpMV on BOTH BASELINE configs[1] matrices (cant, pwtk) with
    own-bytes roofline fractions against the device's published peak;
    matches the reference's committed benchmark driver discipline
    (tests/test_gpu_benchmark/test_gpu_benchmark.cpp:12,96-126)."""
    from libhpc_tpu.bench import matrices
    from libhpc_tpu.ops.spmv_pallas import sbell_spmv_panes, x_to_panes
    from libhpc_tpu.sparse.sbell import SBELL

    peak = _peak_bw()
    for name in ("cant", "pwtk"):
        A = matrices.load_or_synthesize(name)
        m, n = A.shape
        sb = SBELL.from_scipy(A)
        x = x_to_panes(sb, jnp.asarray(np.linspace(
            -1, 1, sb.n_panes * 1024, dtype=np.float32)))
        nbytes = sb.hbm_bytes
        per = time_iterated(lambda v, op: sbell_spmv_panes(op, v), x,
                            iters=64, iters_small=8, operand=sb)
        _emit(f"spmv_sbell_{name}", per, gnnz_per_s=A.nnz / per / 1e9,
              own_bytes_fraction=nbytes / per / peak)

        # bf16 value stream: gated against the bf16-QUANTIZED operator
        # (the matvec accumulates f32)
        sb16 = sb.astype_values(jnp.bfloat16)
        from libhpc_tpu.ops.spmv_pallas import sbell_spmv

        xf = np.linspace(-1, 1, n, dtype=np.float32)
        Aq = A.copy()
        Aq.data = np.asarray(jnp.asarray(A.data).astype(
            jnp.bfloat16).astype(jnp.float32))
        y16 = np.asarray(sbell_spmv(sb16, jnp.asarray(xf)))
        ok16 = np.allclose(y16, Aq @ xf, rtol=2e-3, atol=2e-3)
        if not ok16:
            print(json.dumps({"bench": f"spmv_sbell_{name}_bf16",
                              "error": "incorrect result"}), flush=True)
            continue
        nbytes16 = sb16.hbm_bytes
        per = time_iterated(lambda v, op: sbell_spmv_panes(op, v), x,
                            iters=64, iters_small=8, operand=sb16)
        _emit(f"spmv_sbell_{name}_bf16", per,
              gnnz_per_s=A.nnz / per / 1e9,
              own_bytes_fraction=nbytes16 / per / peak,
              speedup_vs_f32_bytes=nbytes / nbytes16, correct=True)


def bench_spmm_cg():
    """BASELINE configs[2]: SpMM (sparse x 64-col dense) + CG solver loop,
    on Poisson and cant-class — the reference's blocked-matmul/solver
    workload family (test_hpc_benchmark.cpp:758-784) at BASELINE scale.

    Every timed path is gated on an oracle check first (the bench.py
    discipline of never timing an unverified output applies)."""
    from libhpc_tpu.bench import matrices
    from libhpc_tpu.ops import solver, spmv
    from libhpc_tpu.ops.spmm import bsr_spmm, ell_spmm
    from libhpc_tpu.sparse import BSR, CSR, DIA, ELL
    from libhpc_tpu.sparse.sbell import SBELL

    def _gate(name, ok):
        if not ok:
            print(json.dumps({"bench": name, "error": "incorrect result"}),
                  flush=True)
        return ok

    hbm = _peak_bw()
    K = 64
    rng = np.random.default_rng(7)

    # -- SpMM: Poisson via ELL (structured), cant via BSR (FEM blocks) ----
    A = matrices.poisson2d(512)
    ell = ELL.from_csr(CSR.from_scipy(A))
    X = jnp.asarray(rng.standard_normal((A.shape[1], K)).astype(np.float32))
    okm = np.allclose(np.asarray(ell_spmm(ell, X)), A @ np.asarray(X),
                      rtol=2e-3, atol=2e-3)
    # own-bytes: stored vals+cols once, X once, Y once
    nbytes = ell.vals.size * 8 + (A.shape[1] + A.shape[0]) * K * 4
    if _gate("spmm_ell_poisson512_k64", okm):
        per = time_iterated(lambda v: ell_spmm(ell, v) * 1e-2, X, iters=16,
                            iters_small=2)
        _emit("spmm_ell_poisson512_k64", per,
              gflops=2 * A.nnz * K / per / 1e9,
              own_bytes_fraction=nbytes / per / hbm, correct=True)

    Au = matrices.load_or_synthesize("cant")
    bsr = BSR.from_scipy(Au, block=8)
    Xu = jnp.asarray(
        rng.standard_normal((bsr.shape[1], K)).astype(np.float32))
    Yu = np.asarray(bsr_spmm(bsr, Xu))
    Aup = Au.copy()
    Aup.resize(bsr.shape)
    oku = np.allclose(Yu, Aup @ np.asarray(Xu), rtol=2e-3, atol=2e-3)
    nbytes = bsr.blocks.size * 4 + bsr.indices.size * 4 \
        + (bsr.shape[1] + bsr.shape[0]) * K * 4
    if _gate("spmm_bsr_cant_k64", oku):
        per = time_iterated(lambda v: bsr_spmm(bsr, v) * 1e-2, Xu, iters=16,
                            iters_small=2)
        _emit("spmm_bsr_cant_k64", per, gflops=2 * Au.nnz * K / per / 1e9,
              own_bytes_fraction=nbytes / per / hbm, correct=True)

    # -- CG loop: fixed 32 iterations (tol=0 never triggers), its/s --------
    # SHIFTED Poisson (A + I/2): identical structure/traffic, kappa ~17,
    # so 32 iterations converge and the gate means something — f32 CG
    # residual norms on the raw kappa~1e5 system are non-monotone
    import scipy.sparse as sps_

    n_it = 32
    A_sh = (A + sps_.eye(A.shape[0]) * 0.5).tocsr()
    D = DIA.from_scipy(A_sh)
    b = jnp.ones((A.shape[0],), jnp.float32)

    def cg_poisson(v):
        x, _, _ = solver.cg(lambda u: spmv.dia_spmv(D, u), v, tol=0.0,
                            max_iter=n_it)
        return v + x * 1e-30

    xs, _, _ = solver.cg(lambda u: spmv.dia_spmv(D, u), b, tol=0.0,
                         max_iter=n_it)
    r = np.asarray(b) - A_sh @ np.asarray(xs)
    okc = np.isfinite(r).all() and (
        np.linalg.norm(r) < 1e-3 * np.linalg.norm(np.asarray(b)))
    if _gate("cg_dia_poisson512s_32it", okc):
        per = time_iterated(cg_poisson, b, iters=4, iters_small=1)
        _emit("cg_dia_poisson512s_32it", per, iters_per_s=n_it / per,
              gnnz_per_s=n_it * A.nnz / per / 1e9, correct=True)

    from libhpc_tpu.ops.spmv_pallas import (panes_to_x, sbell_spmv_panes,
                                            x_to_panes)

    sb = SBELL.from_scipy(Au)
    # CG entirely in the pane-resident layout (axpy/dot are elementwise,
    # so the solver is layout-oblivious) — the chained form solvers run.
    # cant-like is NOT SPD, so "CG" here is the fixed-iteration workload
    # loop; the gate checks the matvec itself against scipy instead.
    bu = x_to_panes(sb, jnp.ones((sb.n_panes * 1024,), jnp.float32))
    y_pane = panes_to_x(sb, sbell_spmv_panes(sb, bu))[:Au.shape[0]]
    oks = np.allclose(np.asarray(y_pane),
                      Au @ np.ones(Au.shape[1], np.float32),
                      rtol=2e-3, atol=2e-3)

    def cg_cant(v):
        x, _, _ = solver.cg(lambda u: sbell_spmv_panes(sb, u), v, tol=0.0,
                            max_iter=n_it)
        return v + x * 1e-30

    if _gate("cg_sbell_cant_32it", oks):
        per = time_iterated(cg_cant, bu, iters=4, iters_small=1)
        _emit("cg_sbell_cant_32it", per, iters_per_s=n_it / per,
              gnnz_per_s=n_it * Au.nnz / per / 1e9, correct=True)


def bench_scale():
    """BASELINE configs[4] single-device scale: ~100M-nnz SBELL SpMV and
    exact windowed SpGEMM on a 10M+-nnz operand — both oracle-gated before
    timing. Reference benchmark-driver discipline:
    tests/test_gpu_benchmark/test_gpu_benchmark.cpp:12,96-126."""
    import time as _t

    from libhpc_tpu.bench import matrices
    from libhpc_tpu.ops.spmv_pallas import (sbell_spmv, sbell_spmv_panes,
                                            x_to_panes)
    from libhpc_tpu.sparse.sbell import SBELL

    # ---- 100M-nnz SBELL SpMV ----------------------------------------------
    t0 = _t.perf_counter()
    A = matrices.block_random_fast(260_000, blocks_per_row=8, half_band=6,
                                   far_fraction=0.01, seed=3)
    m, n = A.shape
    sb = SBELL.from_scipy(A)
    build_s = _t.perf_counter() - t0
    x = jnp.asarray(np.linspace(-1, 1, n).astype(np.float32))
    y = np.asarray(sbell_spmv(sb, x))
    if not np.allclose(y, A @ np.asarray(x), rtol=2e-3, atol=2e-3):
        raise AssertionError("spmv_sbell_100m: incorrect result")
    x3 = x_to_panes(sb, jnp.pad(x, (0, sb.n_panes * 1024 - n)))
    per = time_iterated(lambda v, op: sbell_spmv_panes(op, v), x3,
                        iters=12, iters_small=2, operand=sb)
    _emit("spmv_sbell_100m", per, gnnz_per_s=A.nnz / per / 1e9,
          own_bytes_fraction=sb.hbm_bytes / per / _peak_bw(),
          nnz_m=round(A.nnz / 1e6, 1), build_s=round(build_s, 1),
          correct=True)
    del A, sb

    # ---- 10M+-nnz exact windowed SpGEMM -----------------------------------
    from libhpc_tpu.ops.spgemm import spgemm_windowed
    from libhpc_tpu.sparse.csr import CSR

    Ap = matrices.pwtk_like()
    Ac = CSR.from_scipy(Ap)
    lenB = np.diff(Ap.indptr).astype(np.int64)
    S = int(lenB[Ap.indices].sum())     # expansion size (partial products)
    t0 = _t.perf_counter()
    C = spgemm_windowed(Ac, Ac, window=1 << 22)
    jax.block_until_ready(C.data)
    t_gemm = _t.perf_counter() - t0
    Cref = (Ap @ Ap).tocsr()
    Cref.sort_indices()
    got = C.to_scipy().tocsr()
    got.sort_indices()
    if not (got.nnz == Cref.nnz and abs(got - Cref).max() < 1e-2):
        raise AssertionError("spgemm_windowed_pwtk_10m: incorrect result")
    _emit("spgemm_windowed_pwtk_10m", t_gemm,
          g_products_per_s=S / t_gemm / 1e9,
          expansion_m=round(S / 1e6, 1),
          nnz_a_m=round(Ap.nnz / 1e6, 1),
          nnz_c_m=round(Cref.nnz / 1e6, 1), correct=True)


def bench_amg():
    """AMG-preconditioned CG with SBELL smoothing: V-cycle apply rate +
    solve iteration count on the SPD-ified cant-class FEM operator."""
    from libhpc_tpu.bench import matrices
    from libhpc_tpu.ops import multigrid_sbell as amg
    from libhpc_tpu.ops.spmv_pallas import sbell_spmv

    A = matrices.spd_from(matrices.load_or_synthesize("cant"))
    H = amg.amg_setup(A, n_levels=3, coarse_max=3000)
    sb = H.levels[0].sbell
    rng = np.random.default_rng(5)
    b = rng.standard_normal(A.shape[0]).astype(np.float32)
    x, it, _ = amg.amg_pcg(H, lambda v: sbell_spmv(sb, v),
                           jnp.asarray(b), tol=1e-6, max_iter=200)
    r = b - A @ np.asarray(x)
    ok = np.linalg.norm(r) <= 2e-6 * max(np.linalg.norm(b), 1.0) * 10
    if not ok:
        raise AssertionError("amg_pcg_cant_spd: incorrect result")
    bj = jnp.asarray(b)
    per = time_iterated(lambda v: amg.amg_vcycle(H, v) * 1e-6 + v * 0.5,
                        bj, iters=8, iters_small=2)
    _emit("amg_vcycle_cant_spd", per,
          levels=len(H.levels) + 1, pcg_iters=int(it), correct=True)


def bench_particle_writes():
    """Reference scale: 2^20 scattered writes (test_hpc_benchmark.cpp:866)."""
    from libhpc_tpu.sparse.grid import BlockGrid

    rng = np.random.default_rng(0)
    n = 1 << 20
    xs = jnp.asarray(rng.integers(0, 4096, n), dtype=jnp.int32)
    ys = jnp.asarray(rng.integers(0, 4096, n), dtype=jnp.int32)
    vals = jnp.ones((n,), jnp.float32)
    g = BlockGrid.create((256, 256), block_size=16, capacity=65536)
    g = g.touch_batch(xs, ys)

    def step(g):
        return g.write_batch(xs, ys, vals)

    per = time_iterated(step, g, iters=8, iters_small=2)
    _emit("particle_writes_1M", per, gwrites_per_s=n / per / 1e9)

    def step_dense(g):
        return g.write_batch_dense(xs, ys, vals)

    per = time_iterated(step_dense, g, iters=8, iters_small=2)
    _emit("particle_writes_dense_1M", per, gwrites_per_s=n / per / 1e9)


def bench_layout():
    """AOS vs SOA vs AOSOA layout sweep — the reference's layout
    benchmarks (test_hpc_benchmark.cpp:35-144) re-expressed: interleaved
    (N, 3) 'array of structs' vs three planar arrays vs tiled
    struct-of-128-lane-vectors for a saxpy-like particle update.

    Sized at 32M particles (384 MB live state) so the working set cannot
    stay cache-resident across loop iterations (a 50 MB L2 would hold the
    reference's 4M scale) — the DRAM-class comparison the reference
    makes."""
    n = 1 << 25

    aos = jnp.ones((n, 3), jnp.float32)

    def step_aos(p):
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        r = x * 1.1 + y * 0.9 + z
        return jnp.stack([x + r * 1e-3, y * 1.0000001, z * 0.9999999], axis=1)

    per = time_iterated(step_aos, aos, iters=256, iters_small=32)
    _emit("layout_aos_32M", per, gb_per_s=2 * aos.nbytes / per / 1e9)

    soa = (jnp.ones((n,), jnp.float32),) * 3

    def step_soa(p):
        x, y, z = p
        r = x * 1.1 + y * 0.9 + z
        return (x + r * 1e-3, y * 1.0000001, z * 0.9999999)

    per = time_iterated(step_soa, soa, iters=256, iters_small=32)
    _emit("layout_soa_32M", per, gb_per_s=2 * 3 * n * 4 / per / 1e9)

    # AOSOA: (n/128, 3, 128) — structs of 128-lane field vectors, the
    # reference's third layout (test_hpc_benchmark.cpp:105-144): each
    # field access is a contiguous 128-wide vector while all three fields
    # of a tile stay local.
    aosoa = jnp.ones((n // 128, 3, 128), jnp.float32)

    def step_aosoa(p):
        x, y, z = p[:, 0, :], p[:, 1, :], p[:, 2, :]
        r = x * 1.1 + y * 0.9 + z
        return jnp.stack([x + r * 1e-3, y * 1.0000001, z * 0.9999999],
                         axis=1)

    per = time_iterated(step_aosoa, aosoa, iters=256, iters_small=32)
    _emit("layout_aosoa_32M", per, gb_per_s=2 * aosoa.nbytes / per / 1e9)


def bench_access():
    """Sequential vs random access — the reference's access-pattern sweep
    (test_hpc_benchmark.cpp:146-290) re-expressed: streaming read vs
    gather-random read of the same 16 MB."""
    n = 1 << 25
    x = jnp.ones((n,), jnp.float32)
    per = time_iterated(lambda v: v * 1.0000001, x, iters=64, iters_small=8)
    _emit("access_sequential_128MB", per, gb_per_s=2 * n * 4 / per / 1e9)

    nr = 1 << 22   # random-gather bench stays at 4M (gather-rate bound,
    xr = jnp.ones((nr,), jnp.float32)   # scale-independent)
    rng = np.random.default_rng(0)
    idx = jnp.asarray(rng.permutation(nr).astype(np.int32))

    def rand_read(v):
        return v + jnp.sum(v[idx]) * 1e-30

    per = time_iterated(rand_read, xr, iters=4, iters_small=1)
    _emit("access_random_16MB", per, gelem_per_s=nr / per / 1e9)


def bench_dtypes():
    """int-width / precision sweep — the reference's int-width benches
    (test_hpc_benchmark.cpp:928-1065): same axpy at f32/bf16/int8.
    128M elements so even the int8 stream exceeds a 50 MB L2."""
    n = 1 << 27
    for dt, name in [(jnp.float32, "f32"), (jnp.bfloat16, "bf16"),
                     (jnp.int8, "i8")]:
        x = jnp.ones((n,), dt)
        if dt == jnp.int8:
            step = lambda v: (v ^ 1)
        else:
            # bf16-representable multiplier: 1.0000001 rounds to exactly
            # 1.0 in bf16 and XLA folds the multiply to identity
            step = lambda v: v * jnp.asarray(1.0078125, dt)
        per = time_iterated(step, x, iters=48, iters_small=6)
        _emit(f"dtype_stream_{name}_128M", per,
              gb_per_s=2 * x.nbytes / per / 1e9)


ALL = {
    "stream": bench_stream,
    "layout": bench_layout,
    "transpose": bench_transpose,
    "matmul": bench_matmul,
    "conv": bench_conv,
    "blur": bench_blur,
    "sort": bench_sort,
    "scan_hist": bench_scan_hist,
    "spmv": bench_spmv,
    "sbell": bench_sbell,
    "spmm_cg": bench_spmm_cg,
    "scale": bench_scale,
    "amg": bench_amg,
    "particles": bench_particle_writes,
    "access": bench_access,
    "dtypes": bench_dtypes,
}


def main(argv):
    for n in argv or list(ALL):
        ALL[n]()


if __name__ == "__main__":
    from libhpc_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    main(sys.argv[1:])
