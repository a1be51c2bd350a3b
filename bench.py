#!/usr/bin/env python
"""Headline benchmark: unstructured SpMV roofline fraction on one GPU.

BASELINE.json configs[1]-class workload: a SuiteSparse cant-class FEM
matrix (real .mtx via $LIBHPC_MATRIX_DIR when present, else the
structurally-matched synthetic stand-in) through auto_format's SBELL
route, plus pwtk, the bf16 value streams, the Poisson routes (DIA, ELL),
SpMM and CG loops, the 500M-key sort, the 100M-nnz-class SpMV and the
block SpGEMM.

  * every result is gated against scipy/numpy in float64 before it is
    timed (tolerance rule: max|y - y_ref| <= 1e-5 * max(|A| @ |x|));
  * each format's roofline fraction is its own byte-traffic model
    (harness.format_spmv_bytes) over time, divided by the device's
    published HBM peak (harness.PEAKS, keyed by device_kind — an
    unknown device is an error). The measured copy and read rates of
    the same card are reported beside it;
  * ell_poisson is a designated NEGATIVE CONTROL (scalar-gather-bound
    by design) and is labeled as such.

Timing: harness.time_iterated (in-program iteration + large/small-M
delta). Runs only on a CUDA GPU: prints the card's name and power limit
(from nvidia-smi, in a child process), then ONE JSON line
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...}.
"""

import json
import sys
import time

T0 = time.perf_counter()


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"bench.py needs a CUDA GPU (JAX's default "
                           f"device is {dev.platform})")
    from libhpc_tpu.bench import harness, matrices
    from libhpc_tpu.utils.cache import enable_compilation_cache

    card = harness.card()
    if card is None:
        raise RuntimeError("nvidia-smi found no GPU")
    print(card, flush=True)

    enable_compilation_cache()
    import os

    import jax.numpy as jnp
    import numpy as np
    import scipy.sparse as sps

    from libhpc_tpu.ops import solver, spmv
    from libhpc_tpu.ops.sort import sort_u32
    from libhpc_tpu.ops.spmv_pallas import sbell_spmv_panes, x_to_panes
    from libhpc_tpu.sparse import CSR, DIA, ELL
    from libhpc_tpu.sparse.auto import auto_format

    peaks = harness.device_peaks(dev.device_kind)
    peak_bw = peaks["hbm_bytes_per_s"]
    matrices_source = "real" if os.environ.get("LIBHPC_MATRIX_DIR") and \
        os.path.exists(os.path.join(
            os.environ["LIBHPC_MATRIX_DIR"], "cant.mtx")) else "synthetic"

    def ok_rule(y, A, x):
        ref = A.astype(np.float64) @ x
        bd = 1e-5 * float(np.max(abs(A) @ np.abs(x.astype(np.float64))))
        return bool(np.abs(np.asarray(y)[:A.shape[0]] - ref).max() <= bd)

    def quantized(A):
        Aq = A.copy()
        Aq.data = np.asarray(jnp.asarray(A.data).astype(
            jnp.bfloat16).astype(jnp.float32))
        return Aq

    def timed(fn, x0, nbytes, nnz, iters, operand=None):
        per = harness.time_iterated(fn, x0, iters=iters,
                                    iters_small=max(1, iters // 8),
                                    operand=operand)
        return dict(seconds=per, gnnz_per_s=nnz / per / 1e9,
                    gb_per_s=nbytes / per / 1e9,
                    roofline_fraction=nbytes / per / peak_bw)

    results, correct = {}, {}

    # ---- unstructured SBELL paths (pane-resident chained form) ----------
    for name in ("cant", "pwtk"):
        A = matrices.load_or_synthesize(name)
        m, n = A.shape
        x = np.linspace(-1.0, 1.0, n, dtype=np.float32)
        for bf16 in (False, True):
            key = f"sbell_{name}" + ("_bf16" if bf16 else "")
            sb, mv = auto_format(A, prefer_bf16=bf16)
            correct[key] = ok_rule(mv(sb, jnp.asarray(x)),
                                   quantized(A) if bf16 else A, x)
            x3 = x_to_panes(sb, jnp.pad(jnp.asarray(x),
                                        (0, sb.n_panes * 1024 - n)))
            scale = 1.0 / float(abs(A).sum(axis=1).max())
            if correct[key]:
                results[key] = timed(
                    lambda v, op: sbell_spmv_panes(op, v) * scale, x3,
                    sb.hbm_bytes, A.nnz, 256 if name == "cant" else 128,
                    operand=sb)
        if name == "cant":
            A_u, sb_u = A, sb

    # ---- structured Poisson 1024^2: DIA, ELL (negative control), CSR ----
    A_s = matrices.poisson2d(1024)
    x_s = np.linspace(-1.0, 1.0, A_s.shape[1], dtype=np.float32)
    csr = CSR.from_scipy(A_s)
    for key, c, f, fmt in (
            ("dia_poisson", DIA.from_scipy(A_s), spmv.dia_spmv, "dia"),
            ("ell_poisson", ELL.from_csr(csr), spmv.ell_spmv, "ell"),
            ("csr_poisson", csr, spmv.csr_spmv, "csr")):
        correct[key] = ok_rule(f(c, jnp.asarray(x_s)), A_s, x_s)
        if correct[key]:
            results[key] = timed(
                lambda v, op, f=f: f(op, v) * 0.125, jnp.asarray(x_s),
                harness.format_spmv_bytes(fmt, c, *A_s.shape), A_s.nnz, 64,
                operand=c)

    # ---- SpMM + CG loops ------------------------------------------------
    from libhpc_tpu.ops.spmm import bsr_spmm
    from libhpc_tpu.sparse import BSR

    loops = {}
    K = 64
    bsr = BSR.from_scipy(A_u, block=8)
    Xu = np.random.default_rng(7).standard_normal(
        (bsr.shape[1], K)).astype(np.float32)
    Aup = A_u.copy()
    Aup.resize(bsr.shape)
    correct["spmm_bsr_cant_k64"] = ok_rule(
        bsr_spmm(bsr, jnp.asarray(Xu)), Aup, Xu)
    if correct["spmm_bsr_cant_k64"]:
        per = harness.time_iterated(lambda v, op: bsr_spmm(op, v) * 1e-2,
                                    jnp.asarray(Xu), iters=16,
                                    iters_small=2, operand=bsr)
        loops["spmm_bsr_cant_k64"] = dict(
            ms=per * 1e3, gflops=2 * A_u.nnz * K / per / 1e9)
    n_it = 32
    for key, op, mvf, A_cg, b in (
            ("cg_sbell_cant_32it", sb_u, None, A_u, None),
            ("cg_dia_poisson1024s_32it",
             DIA.from_scipy(A_s + sps.eye(A_s.shape[0]) * 0.5),
             spmv.dia_spmv, A_s, None)):
        if mvf is None:      # cant is not SPD: solver-loop throughput only
            b = x_to_panes(op, jnp.ones((op.n_panes * 1024,), jnp.float32))
            mv = sbell_spmv_panes
        else:
            b = jnp.ones((A_cg.shape[0],), jnp.float32)
            mv = mvf

        def cg_step(v, o, mv=mv):
            x, _, _ = solver.cg(lambda u: mv(o, u), v, tol=0.0,
                                max_iter=n_it)
            return v + x * 1e-30

        per = harness.time_iterated(cg_step, b, iters=4, iters_small=1,
                                    operand=op)
        loops[key] = dict(ms=per * 1e3, iters_per_s=n_it / per,
                          gnnz_per_s=n_it * A_cg.nnz / per / 1e9)
    del bsr, sb_u

    # ---- 500M u32 sort (the reference's published headline) ------------
    n_sort = 500_000_000
    xs = jax.jit(lambda k: jax.random.bits(k, (n_sort,), jnp.uint32))(
        jax.random.key(0))
    out = sort_u32(xs).block_until_ready()

    def halves(v):
        return (jnp.sum(v & jnp.uint32(0xFFFF)), jnp.sum(v >> jnp.uint32(16)))

    correct["sort_500m_u32"] = bool(jnp.all(out[1:] >= out[:-1])) and all(
        bool(a == b) for a, b in zip(halves(out), halves(xs)))
    del out
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        sort_u32(xs).block_until_ready()
        ts.append(time.perf_counter() - t0)
    t_sort = sorted(ts)[1]
    del xs

    # ---- configs[4] scale: 100M-nnz-class SpMV + block SpGEMM -----------
    A_b = matrices.block_random_fast(260_000, blocks_per_row=8, half_band=6,
                                     far_fraction=0.01, seed=3)
    sb_b, mv = auto_format(A_b)
    x_b = np.linspace(-1, 1, A_b.shape[1]).astype(np.float32)
    correct["sbell_100m"] = ok_rule(mv(sb_b, jnp.asarray(x_b)), A_b, x_b)
    if correct["sbell_100m"]:
        x3 = x_to_panes(sb_b, jnp.pad(jnp.asarray(x_b),
                                      (0, sb_b.n_panes * 1024 - A_b.shape[1])))
        scale = 1.0 / float(abs(A_b).sum(axis=1).max())
        results["sbell_100m"] = timed(
            lambda v, op: sbell_spmv_panes(op, v) * scale, x3,
            sb_b.hbm_bytes, A_b.nnz, 16, operand=sb_b)
    del sb_b, A_b

    from libhpc_tpu.ops import spgemm_bsr as sgb

    A_p = matrices.load_or_synthesize("pwtk")
    Ab_p = BSR.from_scipy(A_p, block=8)
    ai = np.asarray(Ab_p.indices, np.int64)
    ap = np.asarray(Ab_p.indptr, np.int64)
    t0 = time.perf_counter()
    sgb._symbolic(ai, ap, ai, ap, Ab_p.shape[1] // 8)
    t_sym = time.perf_counter() - t0
    t0 = time.perf_counter()
    Cb = sgb.spgemm_bsr(Ab_p, Ab_p)
    jax.block_until_ready(Cb.indices)
    t_gemm = time.perf_counter() - t0
    got = Cb.to_scipy().tocsr()
    got.eliminate_zeros()
    ref = (sps.csr_matrix(Ab_p.to_scipy()) ** 2).tocsr()
    ref.eliminate_zeros()
    d = got - ref
    correct["spgemm_block_pwtk"] = bool(
        (abs(d).max() if d.nnz else 0.0) < 1e-2)

    head = results.get("sbell_cant", {})
    frac = head.get("roofline_fraction", 0.0)
    print(json.dumps({
        "metric": "unstructured_spmv_roofline_fraction",
        "value": round(frac, 4),
        "unit": "fraction_of_published_hbm_peak_own_bytes",
        "vs_baseline": round(frac / 0.80, 4),
        "correct": correct,
        "paths": results,
        "loops": loops,
        "negative_controls": ["ell_poisson"],
        "timed_form": "panes",
        "matrices": matrices_source,
        "measured_copy_gb_per_s": harness.measure_hbm_bandwidth() / 1e9,
        "measured_read_gb_per_s":
            harness.measure_hbm_read_bandwidth() / 1e9,
        "peak_hbm_gb_per_s": peak_bw / 1e9,
        "peak_source": peaks["source"],
        "sort_500m_u32": {"seconds": t_sort,
                          "g_keys_per_s": n_sort / t_sort / 1e9,
                          "reference_3080ti_g_keys_per_s": 1.39},
        "spgemm_block_pwtk": {"host_symbolic_s": t_sym,
                              "total_s": t_gemm},
        "elapsed_s": time.perf_counter() - T0,
        "card": card,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    if not all(correct.values()):
        bad = sorted(k for k, v in correct.items() if not v)
        raise AssertionError(f"incorrect results: {bad}")


if __name__ == "__main__":
    sys.exit(main())
