"""Every float32 contraction on the SpMV, CG and AMG paths names
precision HIGHEST, so a GPU never runs it in TF32 (about 3 decimal
digits). Checked on the lowered StableHLO: each dot_general must carry
HIGHEST on both operands; paths that contract by multiply-sum have none."""

import re

import numpy as np
import pytest
import scipy.sparse as sps

import jax
import jax.numpy as jnp

from libhpc_tpu.bench import matrices
from libhpc_tpu.ops import solver, spmm, spmv
from libhpc_tpu.ops.spmv_pallas import sbell_spmv
from libhpc_tpu.sparse import BSR, CSR, DIA, ELL
from libhpc_tpu.sparse.bell import BELL
from libhpc_tpu.sparse.sbell import SBELL


def dot_generals(fn, *args):
    """The dot_general ops of fn's lowering: list of (line, is_highest)."""
    text = jax.jit(fn).lower(*args).as_text()
    lines = [ln for ln in text.splitlines() if "dot_general" in ln]
    return [(ln, re.search(r"precision = \[HIGHEST, HIGHEST\]", ln)
             is not None) for ln in lines]


def assert_all_highest(fn, *args, min_dots=0):
    dots = dot_generals(fn, *args)
    assert len(dots) >= min_dots, dots
    bad = [ln for ln, ok in dots if not ok]
    assert not bad, bad


def _fem(n_block_rows=60):
    return matrices.block_random(n_block_rows, block=8, blocks_per_row=5,
                                 seed=3, half_band=4, far_fraction=0.05)


def _spd(n_block_rows=120):
    B = _fem(n_block_rows)
    A = (B + B.T).tocsr()
    rowsum = np.asarray(np.abs(A).sum(axis=1)).ravel()
    return (A + sps.diags(rowsum + 1.0)).tocsr().astype(np.float32)


SPMV_CASES = ["bsr", "bell", "far", "sbell", "csr", "ell", "dia"]


@pytest.mark.parametrize("fmt", SPMV_CASES)
def test_spmv_contractions_highest(fmt):
    A = _fem()
    x = jnp.ones(A.shape[1], jnp.float32)
    if fmt == "bsr":
        c = BSR.from_scipy(A, block=8)
        assert_all_highest(spmv.bsr_spmv, c, jnp.ones(c.shape[1]),
                           min_dots=1)
    elif fmt == "bell":
        c = BELL.from_scipy(A)
        assert_all_highest(spmv.bell_spmv, c, jnp.ones(c.shape[1]),
                           min_dots=1)
    elif fmt == "far":
        from libhpc_tpu.ops.spmv_pallas import far_panes

        sb = SBELL.from_scipy(A)
        assert sb.far is not None
        x3 = jnp.ones((sb.n_panes + 2, 8, 128), jnp.float32)
        assert_all_highest(lambda v: far_panes(sb.far, v, sb.n_guarded), x3)
    elif fmt == "sbell":
        sb = SBELL.from_scipy(A)
        assert_all_highest(lambda v: sbell_spmv(sb, v), x)
        assert_all_highest(
            lambda v: sbell_spmv(sb, v, impl="kernel", interpret=True), x)
    elif fmt == "csr":
        assert_all_highest(spmv.csr_spmv, CSR.from_scipy(A), x)
    elif fmt == "ell":
        assert_all_highest(spmv.ell_spmv, ELL.from_scipy(A), x)
    else:
        P = matrices.poisson2d(16)
        assert_all_highest(spmv.dia_spmv, DIA.from_scipy(P),
                           jnp.ones(P.shape[1], jnp.float32))


@pytest.mark.parametrize("op", ["bsr_spmm", "ell_spmm"])
def test_spmm_contractions_highest(op):
    A = _fem()
    if op == "bsr_spmm":
        c = BSR.from_scipy(A, block=8)
        assert_all_highest(spmm.bsr_spmm, c,
                           jnp.ones((c.shape[1], 4), jnp.float32),
                           min_dots=1)
    else:
        c = ELL.from_scipy(A)
        assert_all_highest(spmm.ell_spmm, c,
                           jnp.ones((A.shape[1], 4), jnp.float32),
                           min_dots=1)


def test_cg_step_contractions_highest():
    A = _spd()
    sb = SBELL.from_scipy(A)
    b = jnp.ones(A.shape[0], jnp.float32)
    assert_all_highest(
        lambda v: solver.cg(lambda u: sbell_spmv(sb, u), v, tol=1e-6,
                            max_iter=5)[0], b)


def test_amg_step_contractions_highest():
    from libhpc_tpu.ops.multigrid_sbell import amg_pcg, amg_setup

    A = _spd(400)
    H = amg_setup(A, n_levels=2, coarse_max=500)
    assert H.levels, "expected a two-level hierarchy"
    sb = H.levels[0].sbell
    b = jnp.ones(A.shape[0], jnp.float32)
    # the coarse dense solve is the dot_general of the V-cycle
    assert_all_highest(
        lambda v: amg_pcg(H, lambda u: sbell_spmv(sb, u), v, tol=1e-6,
                          max_iter=3)[0], b, min_dots=1)


def test_dist_amg_step_contractions_highest():
    from jax.sharding import Mesh

    from libhpc_tpu.parallel.dist_amg import dist_amg_build

    mesh = Mesh(np.array(jax.devices()[:8]), ("x",))
    A = _spd(400)
    vcycle, matvec, b_shard = dist_amg_build(A, mesh, 8)
    assert_all_highest(vcycle, b_shard(np.ones(A.shape[0], np.float32)),
                       min_dots=1)


def test_matmul_highest():
    from libhpc_tpu.ops.matmul import matmul

    a = jnp.ones((16, 16), jnp.float32)
    assert_all_highest(matmul, a, a, min_dots=1)


def test_checker_flags_default_precision():
    """The checker itself: a plain f32 jnp.dot is reported."""
    a = jnp.ones((16, 16), jnp.float32)
    dots = dot_generals(jnp.dot, a, a)
    assert len(dots) == 1 and not dots[0][1]
