"""Auxiliary subsystem tests: validation (§5.2), checkpoint (§5.4),
profiling annotations (§5.1), configs (§5.6)."""

import numpy as np
import pytest
import jax.numpy as jnp

from libhpc_tpu.sparse import CSR
from libhpc_tpu.utils import validate, checkpoint
from libhpc_tpu.utils.config import RadixConfig


def good_csr():
    dense = np.array([[1, 0, 2], [0, 0, 0], [3, 4, 0]], np.float32)
    return CSR.from_dense(dense)


def test_validate_csr_ok():
    validate.validate_csr(good_csr())
    err, _ = validate.csr_invariants_checked(good_csr())
    err.throw()  # no violation


def test_validate_csr_bad_index():
    csr = good_csr()
    import dataclasses

    bad = dataclasses.replace(csr, indices=csr.indices.at[0].set(99))
    with pytest.raises(ValueError):
        validate.validate_csr(bad)
    err, _ = validate.csr_invariants_checked(bad)
    with pytest.raises(Exception):
        err.throw()


def test_validate_csr_bad_indptr():
    csr = good_csr()
    import dataclasses

    bad = dataclasses.replace(csr, indptr=csr.indptr.at[1].set(5))
    with pytest.raises(ValueError):
        validate.validate_csr(bad)


def test_checkpoint_roundtrip(tmp_path):
    state = {"x": jnp.arange(10.0), "it": jnp.int32(7),
             "nested": (jnp.ones((3, 3)),)}
    p = str(tmp_path / "ckpt.npz")
    checkpoint.save(p, state)
    back = checkpoint.restore(p, state)
    np.testing.assert_allclose(np.asarray(back["x"]), np.arange(10.0))
    assert int(back["it"]) == 7
    np.testing.assert_allclose(np.asarray(back["nested"][0]), np.ones((3, 3)))


def test_checkpoint_solver_state(tmp_path):
    """Resume a CG run mid-flight: save state, restore, same trajectory."""
    from libhpc_tpu.ops import solver
    from test_spmv_spmm import poisson2d

    A = poisson2d(8)
    csr = CSR.from_scipy(A)
    b = jnp.ones((A.shape[0],), jnp.float32)
    x1, it1, _ = solver.cg(lambda v: csr @ v, b, tol=1e-10, max_iter=20)
    p = str(tmp_path / "x.npz")
    checkpoint.save(p, x1)
    x1b = checkpoint.restore(p, x1)
    # continue from checkpoint — identical to continuing from live state
    x2a, _, _ = solver.cg(lambda v: csr @ v, b, x0=x1, tol=1e-10, max_iter=20)
    x2b, _, _ = solver.cg(lambda v: csr @ v, b, x0=x1b, tol=1e-10, max_iter=20)
    np.testing.assert_allclose(np.asarray(x2a), np.asarray(x2b), rtol=1e-6)


def test_named_scope_runs():
    from libhpc_tpu.utils import profiling
    import jax

    @jax.jit
    def f(x):
        with profiling.annotate("stage_double"):
            return x * 2

    assert float(f(jnp.float32(2.0))) == 4.0


def test_radix_config_validation():
    assert RadixConfig(bits_per_pass=8).n_bins == 256
    assert RadixConfig(bits_per_pass=8).n_passes == 4
    with pytest.raises(ValueError):
        RadixConfig(bits_per_pass=5)
