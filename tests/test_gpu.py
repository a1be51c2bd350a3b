"""Compiled kernels and float32 paths on a CUDA GPU.

Marked `gpu`: they skip on other backends (the `gpu` fixture decides at
run time) and run in-process from chip_smoke.py, or with
LIBHPC_TEST_GPU=1 python -m pytest -m gpu tests/test_gpu.py on the card.
The tolerance rule is the smoke script's: max|y - y_ref| <=
1e-5 * max(|A| @ |x|), about 50x too tight for a TF32 product."""

import numpy as np
import pytest
import scipy.sparse as sps

import jax.numpy as jnp

from libhpc_tpu.bench import matrices

pytestmark = pytest.mark.gpu


def _bound(A, x):
    return 1e-5 * float((abs(A) @ np.abs(x.astype(np.float64))).max())


def _fem(n_block_rows, seed=3, far_fraction=0.02):
    return matrices.block_random_fast(n_block_rows, blocks_per_row=8,
                                      half_band=6, seed=seed,
                                      far_fraction=far_fraction)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_sbell_kernel_compiled(gpu, dtype):
    from libhpc_tpu.ops.spmv_pallas import sbell_spmv
    from libhpc_tpu.sparse.sbell import SBELL

    A = _fem(20_000)
    sb = SBELL.from_scipy(A)
    if dtype == "bf16":
        sb = sb.astype_values(jnp.bfloat16)
        A = A.copy()
        A.data = np.asarray(jnp.asarray(A.data).astype(
            jnp.bfloat16).astype(jnp.float32))
    x = np.random.default_rng(0).standard_normal(A.shape[1]).astype(
        np.float32)
    ref = A.astype(np.float64) @ x
    for impl in ("kernel", "xla"):
        y = np.asarray(sbell_spmv(sb, jnp.asarray(x), impl=impl))
        assert np.abs(y - ref).max() <= _bound(A, x), impl


@pytest.mark.parametrize("n_split", [1, 4])
def test_sbell_kernel_split_compiled(gpu, n_split):
    from libhpc_tpu.ops.spmv_pallas import near_kernel, near_xla, x_to_panes
    from libhpc_tpu.sparse.sbell import SBELL

    sb = SBELL.from_scipy(_fem(4_000, far_fraction=0.0))
    x = np.linspace(-1, 1, sb.n_panes * 1024).astype(np.float32)
    x3 = x_to_panes(sb, jnp.asarray(x))
    got = np.asarray(near_kernel(sb, x3, n_split=n_split))
    want = np.asarray(near_xla(sb, x3))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("fmt", ["bsr", "bell"])
def test_block_spmv_no_tf32(gpu, fmt):
    from libhpc_tpu.ops import spmv
    from libhpc_tpu.sparse import BSR
    from libhpc_tpu.sparse.bell import BELL

    A = _fem(4_000)
    x = np.random.default_rng(1).standard_normal(A.shape[1]).astype(
        np.float32)
    c = BSR.from_scipy(A, block=8) if fmt == "bsr" else BELL.from_scipy(A)
    f = spmv.bsr_spmv if fmt == "bsr" else spmv.bell_spmv
    y = np.asarray(f(c, jnp.asarray(x)))[:A.shape[0]]
    ref = A.astype(np.float64) @ x
    assert np.abs(y - ref).max() <= _bound(A, x)


def test_sort_and_argsort(gpu):
    from libhpc_tpu.ops.sort import argsort_u32, sort_u32

    rng = np.random.default_rng(2)
    x = rng.integers(0, 2**32, size=1 << 20, dtype=np.uint32)
    x[:1000] = x[1000:2000]                     # duplicate keys
    np.testing.assert_array_equal(np.asarray(sort_u32(jnp.asarray(x))),
                                  np.sort(x))
    s, order = argsort_u32(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(order),
                                  np.argsort(x, kind="stable"))


def test_cg_dia_poisson(gpu):
    from libhpc_tpu.ops import solver
    from libhpc_tpu.ops.spmv import dia_spmv
    from libhpc_tpu.sparse import DIA

    A = (matrices.poisson2d(256) + 0.5 * sps.eye(256 * 256)).tocsr() \
        .astype(np.float32)
    dia = DIA.from_scipy(A)
    b = np.ones(A.shape[0], np.float32)
    x, it, _ = solver.cg(lambda v: dia_spmv(dia, v), jnp.asarray(b),
                         tol=1e-6, max_iter=500)
    r = b - A.astype(np.float64) @ np.asarray(x, np.float64)
    assert np.linalg.norm(r) / np.linalg.norm(b) <= 1e-5
    assert 0 < int(it) < 500


def test_amg_coarse_solve_no_tf32(gpu):
    """The V-cycle's dense coarse solve at HIGHEST precision: AMG-PCG
    reaches the float64 residual bound."""
    from libhpc_tpu.ops.multigrid_sbell import amg_pcg, amg_setup
    from libhpc_tpu.ops.spmv_pallas import sbell_spmv

    B = matrices.block_random(2000, block=8, blocks_per_row=6, seed=11,
                              half_band=5, far_fraction=0.02)
    A = (B + B.T).tocsr()
    rowsum = np.asarray(np.abs(A).sum(axis=1)).ravel()
    A = (A + sps.diags(rowsum + 1.0)).tocsr().astype(np.float32)
    H = amg_setup(A, n_levels=3)
    sb = H.levels[0].sbell
    b = np.random.default_rng(0).standard_normal(A.shape[0]).astype(
        np.float32)
    x, it, _ = amg_pcg(H, lambda v: sbell_spmv(sb, v), jnp.asarray(b),
                       tol=1e-6)
    r = b - A.astype(np.float64) @ np.asarray(x, np.float64)
    assert np.linalg.norm(r) / np.linalg.norm(b) <= 1e-5
