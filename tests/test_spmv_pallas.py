"""SBELL SpMV tests: the XLA form (the default route on the CPU) and the
Triton kernel in the Pallas interpreter; the compiled kernel runs on the
GPU through the `gpu`-marked tests.

Oracle style follows the reference's stage tests (SURVEY.md §4.1):
scipy dense matvec as ground truth, edge sizes spanning sub-tile,
non-multiple, and multi-stripe scales.
"""

import numpy as np
import pytest
import scipy.sparse as sps

import jax.numpy as jnp

from libhpc_tpu.bench import matrices
from libhpc_tpu.ops.spmv_pallas import sbell_spmv
from libhpc_tpu.sparse.sbell import SBELL


def _check(A, rtol=1e-4, atol=1e-5, **kw):
    sb = SBELL.from_scipy(A)
    x = np.linspace(-1.0, 1.0, A.shape[1]).astype(np.float32)
    y = np.asarray(sbell_spmv(sb, jnp.asarray(x), **kw))
    y_ref = A @ x
    np.testing.assert_allclose(y, y_ref, rtol=rtol, atol=atol)
    return sb


@pytest.mark.parametrize("n", [8, 64, 1000, 1024, 1048, 2500])
def test_sbell_random_sizes(rng, n):
    A = sps.random(n, n, density=min(0.05, 2000 / (n * n) + 0.001),
                   format="csr", dtype=np.float32, random_state=42)
    A.setdiag(1.0)
    _check(A)


def test_sbell_rect():
    A = sps.random(500, 1300, density=0.01, format="csr",
                   dtype=np.float32, random_state=7)
    _check(A)


def test_sbell_block_structured(rng):
    A = matrices.block_random(400, block=8, blocks_per_row=8, seed=3,
                              far_fraction=0.0)
    sb = _check(A)
    # purely banded: the bulk rides the kernel path; only sub-MIN_OCCUPANCY
    # slivers (tail-stripe slices, stray deep slices) may route far
    assert sb.far_fraction < 0.02
    # on a tiny 4-stripe matrix the tail stripe is a large fraction, so its
    # slot padding inflates fill; large matrices (cant/pwtk) sit near 1.1
    assert sb.fill_ratio(A.nnz) < 2.2


def test_sbell_far_split(rng):
    """Scattered blocks route to the far path; banded bulk stays on the
    kernel path; the sum is still exact."""
    A = matrices.block_random(400, block=8, blocks_per_row=8, seed=3,
                              far_fraction=0.3)
    sb = _check(A)
    assert sb.far is not None
    assert 0.0 < sb.far_fraction < 0.5


def test_sbell_poisson():
    A = matrices.poisson2d(64)
    _check(A)


def test_sbell_multi_pane_spread(rng):
    """Columns scattered across many panes (far blocks) — exercises the
    greedy tile cut and per-tile dynamic pane windows."""
    n = 6000
    rows = np.repeat(np.arange(n), 3)
    cols = np.concatenate([
        np.arange(n),                                  # diagonal
        (np.arange(n) * 977) % n,                      # pseudo-random far
        (np.arange(n) * 31 + 17) % n,
    ])
    vals = np.ones_like(cols, dtype=np.float32)
    A = sps.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    A.sum_duplicates()
    _check(A)


def test_sbell_empty_rows():
    A = sps.csr_matrix((1024, 1024), dtype=np.float32)
    A[5, 7] = 2.0
    A = A.tocsr()
    sb = SBELL.from_scipy(A)
    x = np.arange(1024, dtype=np.float32)
    y = np.asarray(sbell_spmv(sb, jnp.asarray(x)))
    assert y[5] == 14.0
    assert np.count_nonzero(y) == 1


def test_sbell_duplicate_block_cols():
    """Multiple slots with the same (row, col) accumulate additively."""
    A = sps.csr_matrix(
        (np.array([1.0, 2.0, 3.0], np.float32),
         (np.array([0, 0, 0]), np.array([0, 200, 4000]))),
        shape=(128, 8192))
    _check(A)


def test_sbell_spmv_padded_domain():
    """Padded-domain variant: pad cols are zeros, pad rows inert; result
    matches the public op and the scipy oracle on the true rows."""
    from libhpc_tpu.ops.spmv_pallas import sbell_spmv_padded

    A = matrices.block_random(150, block=8, blocks_per_row=5, seed=9,
                              half_band=5, far_fraction=0.05)
    sb = SBELL.from_scipy(A)
    m, n = A.shape
    x = np.linspace(-1, 1, n).astype(np.float32)
    xpad = jnp.asarray(np.pad(x, (0, sb.n_panes * 1024 - n)))
    ypad = np.asarray(sbell_spmv_padded(sb, xpad))
    assert ypad.shape[0] == sb.n_stripes * 1024
    np.testing.assert_allclose(ypad[:m], A @ x, rtol=1e-4, atol=1e-5)
    assert np.all(ypad[m:] == 0.0)
    y_pub = np.asarray(sbell_spmv(sb, jnp.asarray(x)))
    np.testing.assert_allclose(ypad[:m], y_pub, rtol=1e-6, atol=1e-7)


def test_sbell_spmv_panes_chain():
    """Pane-resident chained form: matches the flat API, and chaining
    y->x through the pane layout equals two flat matvecs (A @ (A @ x))."""
    from libhpc_tpu.ops.spmv_pallas import (panes_to_x, sbell_spmv_panes,
                                            x_to_panes)

    A = matrices.block_random(260, block=8, blocks_per_row=5, seed=13,
                              half_band=5, far_fraction=0.04)
    m, n = A.shape
    assert m == n
    sb = SBELL.from_scipy(A)
    x = np.linspace(-1, 1, n).astype(np.float32)
    xpad = np.pad(x, (0, sb.n_panes * 1024 - n))
    x3 = x_to_panes(sb, jnp.asarray(xpad))
    o3 = sbell_spmv_panes(sb, x3)
    assert o3.shape[0] == sb.n_stripes + 2   # guarded output
    assert np.all(np.asarray(o3[sb.n_stripes:]) == 0.0)
    y = np.asarray(panes_to_x(sb, o3))[:m]
    np.testing.assert_allclose(y, A @ x, rtol=1e-4, atol=1e-5)
    # chain: second application without leaving pane layout — the guarded
    # output IS the next guarded x, zero wrapper ops
    o6 = sbell_spmv_panes(sb, o3)
    y2 = np.asarray(panes_to_x(sb, o6))[:m]
    Ap = A.copy(); Ap.resize((sb.n_stripes * 1024, sb.n_panes * 1024))
    np.testing.assert_allclose(y2, (Ap @ (Ap @ xpad))[:m], rtol=1e-3,
                               atol=1e-4)


def test_sbell_bf16_values():
    """bf16 value-stream variant: matches the bf16-QUANTIZED
    operator tightly (the kernel accumulates f32) and the f32 operator
    within bf16's value-rounding bound."""
    A = matrices.block_random(260, block=8, blocks_per_row=6, seed=21,
                              half_band=5, far_fraction=0.05)
    sb16 = SBELL.from_scipy(A).astype_values(jnp.bfloat16)
    assert sb16.vflat.dtype == jnp.bfloat16
    x = np.linspace(-1.0, 1.0, A.shape[1]).astype(np.float32)
    y = np.asarray(sbell_spmv(sb16, jnp.asarray(x)))
    # exact-layout oracle: the uniformly bf16-quantized operator applied
    # in f32 — the kernel accumulates f32, so this matches tightly
    Aq = A.copy()
    Aq.data = np.asarray(
        jnp.asarray(A.data).astype(jnp.bfloat16).astype(jnp.float32))
    y_q = Aq @ x
    y_f = A @ x
    scale = np.max(np.abs(y_f)) + 1e-30
    np.testing.assert_allclose(y, y_q, rtol=1e-4, atol=1e-4)
    # vs the f32 operator: bounded by bf16's 2^-8 value rounding
    assert np.max(np.abs(y - y_f)) / scale < 2e-2
    # bf16 stream must be half the f32 stream on the value term
    sb32 = SBELL.from_scipy(A)
    assert sb16.hbm_bytes < sb32.hbm_bytes
    assert sb16.vflat.size * 2 == sb16.vflat.size * sb16.vflat.dtype.itemsize


# ---------------------------------------------------------------------------
# The Triton kernel in the Pallas interpreter
# ---------------------------------------------------------------------------


def _multi_pane_spread(n=6000):
    rows = np.repeat(np.arange(n), 3)
    cols = np.concatenate([np.arange(n), (np.arange(n) * 977) % n,
                           (np.arange(n) * 31 + 17) % n])
    A = sps.coo_matrix((np.ones(cols.size, np.float32), (rows, cols)),
                       shape=(n, n)).tocsr()
    A.sum_duplicates()
    return A


KERNEL_CASES = {
    "random_1048": lambda: sps.random(
        1048, 1048, density=0.003, format="csr", dtype=np.float32,
        random_state=42) + sps.eye(1048, dtype=np.float32),
    "rect_500x1300": lambda: sps.random(
        500, 1300, density=0.01, format="csr", dtype=np.float32,
        random_state=7),
    "block_banded": lambda: matrices.block_random(
        400, block=8, blocks_per_row=8, seed=3, far_fraction=0.0),
    "block_far_split": lambda: matrices.block_random(
        400, block=8, blocks_per_row=8, seed=3, far_fraction=0.3),
    "poisson64": lambda: matrices.poisson2d(64),
    "multi_pane_spread": _multi_pane_spread,
    "duplicate_block_cols": lambda: sps.csr_matrix(
        (np.array([1.0, 2.0, 3.0], np.float32),
         (np.array([0, 0, 0]), np.array([0, 200, 4000]))),
        shape=(128, 8192)),
}


@pytest.mark.parametrize("name", list(KERNEL_CASES))
def test_sbell_kernel_interpret(name):
    A = sps.csr_matrix(KERNEL_CASES[name](), dtype=np.float32)
    _check(A, impl="kernel", interpret=True)


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 64])
def test_sbell_kernel_split_stripes(n_split):
    """Stripes split over n_split programs (strided tile walk + XLA sum of
    the partial planes) give the same product as the XLA form, including
    splits wider than a stripe's tile count."""
    from libhpc_tpu.ops.spmv_pallas import near_kernel, near_xla, x_to_panes

    A = matrices.block_random(400, block=8, blocks_per_row=8, seed=4,
                              half_band=6, far_fraction=0.02)
    sb = SBELL.from_scipy(A)
    x = np.linspace(-1, 1, sb.n_panes * 1024).astype(np.float32)
    x3 = x_to_panes(sb, jnp.asarray(x))
    got = np.asarray(near_kernel(sb, x3, n_split=n_split, interpret=True))
    want = np.asarray(near_xla(sb, x3))
    assert got.shape == (sb.n_guarded, 8, 128)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.all(got[sb.n_stripes:] == 0.0)    # guard stripes stay zero


def test_sbell_kernel_bf16_values():
    """bf16 values are widened in registers; the kernel accumulates f32
    and matches the bf16-quantized operator."""
    A = matrices.block_random(260, block=8, blocks_per_row=6, seed=21,
                              half_band=5, far_fraction=0.05)
    sb16 = SBELL.from_scipy(A).astype_values(jnp.bfloat16)
    x = np.linspace(-1.0, 1.0, A.shape[1]).astype(np.float32)
    y = np.asarray(sbell_spmv(sb16, jnp.asarray(x), impl="kernel",
                              interpret=True))
    Aq = A.copy()
    Aq.data = np.asarray(
        jnp.asarray(A.data).astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_allclose(y, Aq @ x, rtol=1e-4, atol=1e-4)


def test_sbell_kernel_padding_tiles():
    """Zero padding tiles (as the distributed builder appends) join the
    first guard stripe and leave the product and the guards unchanged."""
    import dataclasses

    from libhpc_tpu.sparse.sbell import VROWS, tile_pointer

    A = matrices.block_random(200, block=8, blocks_per_row=5, seed=6,
                              half_band=4, far_fraction=0.0)
    sb = SBELL.from_scipy(A)
    extra = 5
    sid = np.concatenate([np.asarray(sb.sid),
                          np.full(extra, sb.n_stripes, np.int32)])
    padded = dataclasses.replace(
        sb, vflat=jnp.pad(sb.vflat, ((0, extra * VROWS), (0, 0))),
        meta=jnp.pad(sb.meta, ((0, extra), (0, 0))),
        pane=jnp.pad(sb.pane, (0, extra)), sid=jnp.asarray(sid),
        tptr=jnp.asarray(tile_pointer(sid, sb.n_guarded)))
    x = np.linspace(-1.0, 1.0, A.shape[1]).astype(np.float32)
    for kw in (dict(impl="kernel", interpret=True), dict(impl="xla")):
        y = np.asarray(sbell_spmv(padded, jnp.asarray(x), **kw))
        np.testing.assert_allclose(y, A @ x, rtol=1e-4, atol=1e-5)


def test_sbell_empty_operator_has_inert_tile():
    A = sps.csr_matrix((300, 300), dtype=np.float32)
    sb = SBELL.from_scipy(A)
    assert sb.n_tiles == 1 and int(sb.sid[0]) == sb.n_stripes
    assert np.asarray(sb.tptr).tolist() == [0, 0, 1, 1]
    for kw in (dict(impl="kernel", interpret=True), dict(impl="xla")):
        y = np.asarray(sbell_spmv(sb, jnp.ones(300, jnp.float32), **kw))
        assert y.shape == (300,) and not y.any()


def test_sbell_kernel_choice():
    """The wrapper picks the XLA form off the GPU; the split follows the
    shapes: enough programs to fill the card, never more than a stripe's
    mean tile count."""
    from libhpc_tpu.ops import spmv_pallas as sp

    assert sp.default_impl() == "xla"
    A = matrices.block_random(400, block=8, blocks_per_row=8, seed=3,
                              far_fraction=0.0)
    sb = SBELL.from_scipy(A)
    per_stripe = -(-sb.n_tiles // sb.n_stripes)
    assert sp.n_split_for(sb) == min(per_stripe,
                                     -(-sp.TARGET_PROGRAMS // sb.n_guarded))
    with pytest.raises(ValueError, match="impl"):
        sp.sbell_spmv(sb, jnp.zeros(A.shape[1], jnp.float32), impl="mxu")


def test_sbell_kernel_without_interpret_raises_off_gpu():
    """The kernel compiles for CUDA GPUs only: called for real on the CPU
    it raises instead of silently running the interpreter."""
    A = matrices.poisson2d(32)
    sb = SBELL.from_scipy(A)
    with pytest.raises(RuntimeError, match="CUDA GPUs only"):
        sbell_spmv(sb, jnp.zeros(A.shape[1], jnp.float32), impl="kernel")


# ---------------------------------------------------------------------------
# Far set (block-COO) in pane layout
# ---------------------------------------------------------------------------


def _far_only(sb, A, x):
    """Oracle for the far contribution: the full product minus the near
    tiles' XLA product, in guarded pane layout."""
    from libhpc_tpu.ops.spmv_pallas import near_xla, x_to_panes

    xpad = np.pad(x, (0, sb.n_panes * 1024 - A.shape[1]))
    x3 = x_to_panes(sb, jnp.asarray(xpad))
    ypad = np.zeros(sb.n_guarded * 1024, np.float64)
    ypad[:A.shape[0]] = A.astype(np.float64) @ x
    total = ypad.reshape(sb.n_guarded, 128, 8).transpose(0, 2, 1)
    return x3, total - np.asarray(near_xla(sb, x3))


@pytest.mark.parametrize("seed", [21, 5])
def test_far_panes_vs_oracle(seed):
    from libhpc_tpu.ops.spmv_pallas import far_panes

    A = matrices.block_random(260, block=8, blocks_per_row=6, seed=seed,
                              half_band=5, far_fraction=0.05)
    sb = SBELL.from_scipy(A)
    assert sb.far is not None
    x = np.linspace(-1, 1, A.shape[1]).astype(np.float32)
    x3, far_ref = _far_only(sb, A, x)
    got = np.asarray(far_panes(sb.far, x3, sb.n_guarded))
    np.testing.assert_allclose(got, far_ref, rtol=1e-4, atol=1e-4)
    assert np.all(got[sb.n_stripes:] == 0.0)


def test_far_multi_pane_stripe():
    """Far entries of one stripe scattered over many panes."""
    rows = np.arange(128, dtype=np.int64) * 8          # block rows 0..127
    cols = (np.arange(128, dtype=np.int64) * 977) % 2000
    A = sps.coo_matrix(
        (np.linspace(1, 2, 128, dtype=np.float32), (rows, cols * 8)),
        shape=(1024, 2048 * 8)).tocsr()
    sb = SBELL.from_scipy(A)
    x = np.linspace(-1, 1, A.shape[1]).astype(np.float32)
    for kw in (dict(impl="kernel", interpret=True), dict(impl="xla")):
        y = np.asarray(sbell_spmv(sb, jnp.asarray(x), **kw))
        np.testing.assert_allclose(y, A @ x, rtol=1e-4, atol=1e-4)


def test_far_bf16_cast():
    A = matrices.block_random(260, block=8, blocks_per_row=6, seed=9,
                              half_band=5, far_fraction=0.05)
    sb16 = SBELL.from_scipy(A).astype_values(jnp.bfloat16)
    assert sb16.far.blocks.dtype == jnp.bfloat16
    Aq = A.copy()
    Aq.data = np.asarray(
        jnp.asarray(A.data).astype(jnp.bfloat16).astype(jnp.float32))
    x = np.linspace(-1, 1, A.shape[1]).astype(np.float32)
    y = np.asarray(sbell_spmv(sb16, jnp.asarray(x)))
    np.testing.assert_allclose(y, Aq @ x, rtol=1e-4, atol=1e-4)


def test_sbell_builder_invariants():
    """Every stored block lands exactly once: near slots + far blocks =
    the BSR block count; tiles are stripe-major and tptr brackets them."""
    A = matrices.block_random(260, block=8, blocks_per_row=6, seed=13,
                              half_band=5, far_fraction=0.05)
    sb = SBELL.from_scipy(A)
    meta_used = np.asarray(sb.vflat).reshape(sb.n_tiles, 64, 128) \
        .any(axis=1).sum()
    n_blocks = A.tobsr((8, 8)).indices.size
    assert int(meta_used) + sb.far.n_far == n_blocks
    sid = np.asarray(sb.sid)
    tptr = np.asarray(sb.tptr)
    assert np.all(np.diff(sid) >= 0)
    for s in range(sb.n_guarded):
        assert np.all(sid[tptr[s]:tptr[s + 1]] == s)
    assert tptr[-1] == sb.n_tiles
