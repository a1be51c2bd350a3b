"""Distributed SBELL SpMV on the 8-virtual-device CPU mesh."""

import numpy as np
import pytest
import scipy.sparse as sps

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from libhpc_tpu.bench import matrices
from libhpc_tpu.parallel.dist_sbell import DistSBELL, dist_sbell_spmv_fn


@pytest.fixture
def mesh():
    devs = np.array(jax.devices()[:8])
    return Mesh(devs, ("x",))


def _run(A, mesh, n_shards=8):
    dA = DistSBELL.from_scipy(A, n_shards).shard(mesh)
    n = dA.shape[1]
    x = np.linspace(-1.0, 1.0, n).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("x")))
    y = np.asarray(dist_sbell_spmv_fn(dA, mesh)(xs))
    x0 = x[:A.shape[1]]
    expect = A @ x0
    np.testing.assert_allclose(y[:A.shape[0]], expect, rtol=1e-4, atol=1e-4)
    assert np.allclose(y[A.shape[0]:], 0.0)
    return dA


def test_dist_sbell_fem(mesh):
    A = matrices.block_random(1500, block=8, blocks_per_row=6, seed=5)
    _run(A, mesh)


def test_dist_sbell_poisson(mesh):
    A = matrices.poisson2d(96)
    _run(A, mesh)


def test_dist_sbell_banded_mostly_near(mesh):
    """A purely banded matrix: the bulk of every shard's diag/offd stays
    on the kernel path; only sub-MIN_OCCUPANCY slivers at shard/stripe
    boundaries may route far (cheaper there — sparse/sbell.py)."""
    n = 9000
    A = sps.diags([np.ones(n - k) for k in (0, 1, 2, 3)], [0, -1, 2, 17],
                  shape=(n, n), format="csr", dtype=np.float32)
    dA = _run(A, mesh)
    if dA.has_far:
        far_blocks = int(dA.far_rows.shape[0] * dA.far_rows.shape[1])
        near_slots = int(dA.diag_vflat.size + dA.offd_vflat.size) // (64 * 128)
        assert far_blocks < 0.05 * near_slots + 8 * dA.n_shards


def test_dist_sbell_kernel_shards(mesh):
    """The Triton SBELL kernel (Pallas interpreter) inside shard_map on a
    larger operator: same result as scipy and as the XLA form."""
    A = matrices.block_random(3000, block=8, blocks_per_row=6, seed=5)
    dA = DistSBELL.from_scipy(A, 8).shard(mesh)
    n = dA.shape[1]
    x = np.linspace(-1.0, 1.0, n).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("x")))
    y = np.asarray(dist_sbell_spmv_fn(dA, mesh, impl="kernel",
                                      interpret=True)(xs))
    expect = A @ x[:A.shape[1]]
    np.testing.assert_allclose(y[:A.shape[0]], expect, rtol=1e-4,
                               atol=1e-4)
    y_xla = np.asarray(dist_sbell_spmv_fn(dA, mesh, impl="xla")(xs))
    np.testing.assert_allclose(y, y_xla, rtol=1e-5, atol=1e-5)
