"""Distributed-layer tests on the 8-virtual-device CPU mesh (SURVEY.md §4.6:
multi-host simulation — the reference has no multi-node tests; this is the
build's new coverage)."""

import numpy as np
import pytest
import scipy.sparse as sps
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from libhpc_tpu.parallel import mesh as meshmod, halo as halomod
from libhpc_tpu.parallel.dist_spmv import DistCSR, dist_spmv_fn, dist_cg
from libhpc_tpu.parallel.dist_stencil import dist_blur2d_fn, dist_poisson_fn
from test_spmv_spmm import poisson2d
from test_stencil import naive_blur_x, naive_blur_y


needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 devices")


@needs_8
def test_halo_exchange():
    mesh = meshmod.make_mesh_1d(8)
    m, n = 64, 128  # 8 rows per shard
    x = jnp.arange(m * n, dtype=jnp.float32).reshape(m, n)

    def body(shard):
        top, bot = halomod.exchange_halo_1d(shard, 2, "x")
        return jnp.concatenate([top, bot], axis=0)

    f = jax.jit(jax.shard_map(body, mesh=mesh, in_specs=P("x"),
                              out_specs=P("x")))
    xs = jax.device_put(x, NamedSharding(mesh, P("x")))
    out = np.asarray(f(xs)).reshape(8, 4, n)
    xn = np.asarray(x).reshape(8, 8, n)
    for s in range(8):
        top_expect = xn[s - 1, -2:, :] if s > 0 else np.zeros((2, n))
        bot_expect = xn[s + 1, :2, :] if s < 7 else np.zeros((2, n))
        np.testing.assert_array_equal(out[s, :2], top_expect)
        np.testing.assert_array_equal(out[s, 2:], bot_expect)


@needs_8
@pytest.mark.parametrize("overlap", [False, True])
def test_dist_blur2d(rng, overlap):
    mesh = meshmod.make_mesh_1d(8)
    a = rng.random((128, 256)).astype(np.float32)  # 16 rows/shard, r=2 fits
    f = dist_blur2d_fn(mesh, radius=2, overlap=overlap)
    xs = jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("x")))
    got = np.asarray(f(xs))
    expect = naive_blur_y(naive_blur_x(a, 2), 2)
    np.testing.assert_allclose(got, expect, rtol=1e-3, atol=1e-3)


@needs_8
def test_dist_blur2d_overlapped_radius8(rng):
    mesh = meshmod.make_mesh_1d(8)
    a = rng.random((512, 256)).astype(np.float32)  # 64 rows/shard ≥ 4r
    f = dist_blur2d_fn(mesh, radius=8, overlap=True)
    xs = jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("x")))
    got = np.asarray(f(xs))
    expect = naive_blur_y(naive_blur_x(a, 8), 8)
    np.testing.assert_allclose(got, expect, rtol=1e-3, atol=1e-3)


@needs_8
def test_dist_poisson(rng):
    from libhpc_tpu.ops.stencil import poisson5_apply

    mesh = meshmod.make_mesh_1d(8)
    u = rng.random((64, 64)).astype(np.float32)
    f = dist_poisson_fn(mesh)
    us = jax.device_put(jnp.asarray(u), NamedSharding(mesh, P("x")))
    got = np.asarray(f(us))
    np.testing.assert_allclose(got, np.asarray(poisson5_apply(jnp.asarray(u))),
                               rtol=1e-4, atol=1e-4)


@needs_8
def test_dist_spmv_poisson(rng):
    mesh = meshmod.make_mesh_1d(8)
    A = poisson2d(16)  # 256×256
    dA = DistCSR.from_scipy(A, 8).shard(mesh)
    x = rng.random(A.shape[0]).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("x")))
    matvec = dist_spmv_fn(dA, mesh)
    got = np.asarray(matvec(xs))
    np.testing.assert_allclose(got, A @ x, rtol=1e-4, atol=1e-4)


@needs_8
def test_dist_spmv_nonsquare_padding(rng):
    mesh = meshmod.make_mesh_1d(8)
    # 100 rows -> pads to 104 with identity tail
    A = sps.random(100, 100, density=0.05, format="csr", dtype=np.float32,
                   random_state=np.random.RandomState(17))
    dA = DistCSR.from_scipy(A, 8).shard(mesh)
    n_pad = dA.shape[0]
    x = np.zeros(n_pad, np.float32)
    x[:100] = rng.random(100).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("x")))
    got = np.asarray(dist_spmv_fn(dA, mesh)(xs))
    np.testing.assert_allclose(got[:100], A @ x[:100], rtol=1e-4, atol=1e-4)


@needs_8
def test_dist_cg(rng):
    mesh = meshmod.make_mesh_1d(8)
    A = poisson2d(16)
    dA = DistCSR.from_scipy(A, 8).shard(mesh)
    x_true = rng.random(A.shape[0]).astype(np.float32)
    b = jnp.asarray(A @ x_true)
    bs = jax.device_put(b, NamedSharding(mesh, P("x")))
    x, it, res = dist_cg(dA, bs, mesh, tol=1e-5, max_iter=2000)
    assert int(it) < 2000
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-2, atol=1e-2)


@needs_8
@pytest.mark.slow
def test_overlap_bench_runs(capsys):
    from libhpc_tpu.bench import overlap

    eff = overlap.run(8, 256, 256, 2)
    assert eff > 0


@needs_8
@pytest.mark.slow
def test_scaling_bench_runs(capsys):
    from libhpc_tpu.bench import scaling

    out = scaling.run(2048, 4)
    assert out["dia"][1]["gnnz_per_s"] > 0
    # DistSBELL weak-scaling curve: present and measured
    assert out["sbell"][1]["gnnz_per_s"] > 0
    assert set(out["sbell"]) == {1, 2, 4}


@needs_8
def test_dist_poisson3d(rng):
    from libhpc_tpu.ops.stencil import poisson7_apply
    from libhpc_tpu.parallel.dist_stencil import dist_poisson3d_fn

    mesh = meshmod.make_mesh_1d(8)
    u = rng.random((32, 16, 16)).astype(np.float32)
    f = dist_poisson3d_fn(mesh)
    us = jax.device_put(jnp.asarray(u), NamedSharding(mesh, P("x")))
    got = np.asarray(f(us))
    np.testing.assert_allclose(
        got, np.asarray(poisson7_apply(jnp.asarray(u))), rtol=1e-4, atol=1e-4
    )


@needs_8
def test_dist_dia_spmv_poisson(rng):
    from libhpc_tpu.parallel.dist_dia import DistDIA, dist_dia_spmv_fn

    mesh = meshmod.make_mesh_1d(8)
    A = poisson2d(16)  # 256 rows, bandwidth 16 <= 32 rows/shard
    dA = DistDIA.from_scipy(A, 8).shard(mesh)
    x = rng.random(A.shape[0]).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("x")))
    got = np.asarray(dist_dia_spmv_fn(dA, mesh)(xs))
    np.testing.assert_allclose(got, A @ x, rtol=1e-4, atol=1e-4)


@needs_8
def test_dist_dia_nonmultiple_rows(rng):
    from libhpc_tpu.parallel.dist_dia import DistDIA, dist_dia_spmv_fn
    import scipy.sparse as sps2

    # 100 rows pads to 104; tridiagonal so bandwidth 1
    n = 100
    A = sps2.diags([np.full(n - 1, -1.0), np.full(n, 2.0),
                    np.full(n - 1, -1.0)], [-1, 0, 1]).tocsr().astype(np.float32)
    mesh = meshmod.make_mesh_1d(8)
    dA = DistDIA.from_scipy(A, 8).shard(mesh)
    x = np.zeros(dA.shape[0], np.float32)
    x[:n] = rng.random(n).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("x")))
    got = np.asarray(dist_dia_spmv_fn(dA, mesh)(xs))
    np.testing.assert_allclose(got[:n], A @ x[:n], rtol=1e-4, atol=1e-4)


@needs_8
def test_dist_dia_cg(rng):
    from libhpc_tpu.parallel.dist_dia import DistDIA, dist_dia_cg

    mesh = meshmod.make_mesh_1d(8)
    A = poisson2d(16)
    dA = DistDIA.from_scipy(A, 8).shard(mesh)
    x_true = rng.random(A.shape[0]).astype(np.float32)
    bs = jax.device_put(jnp.asarray(A @ x_true), NamedSharding(mesh, P("x")))
    x, it, _ = dist_dia_cg(dA, bs, mesh, tol=1e-5, max_iter=2000)
    assert int(it) < 2000
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-2, atol=1e-2)


@needs_8
def test_dist_dia_bandwidth_guard():
    from libhpc_tpu.parallel.dist_dia import DistDIA

    A = poisson2d(64)  # 4096 rows, bandwidth 64 > 4096/8? no: 512 rows/shard
    DistDIA.from_scipy(A, 8)  # fine
    with pytest.raises(ValueError):
        DistDIA.from_scipy(poisson2d(8), 32)  # 2 rows/shard < bandwidth 8


@needs_8
def test_dist_spmm(rng):
    from libhpc_tpu.parallel.dist_spmv import dist_spmm_fn

    mesh = meshmod.make_mesh_1d(8)
    A = poisson2d(16)  # 256×256
    dA = DistCSR.from_scipy(A, 8).shard(mesh)
    B = rng.random((A.shape[1], 16)).astype(np.float32)
    Bs = jax.device_put(jnp.asarray(B), NamedSharding(mesh, P("x")))
    got = np.asarray(dist_spmm_fn(dA, mesh, 16)(Bs))
    np.testing.assert_allclose(got, A @ B, rtol=1e-3, atol=1e-3)


@needs_8
@pytest.mark.parametrize("grid,realign", [((2, 2), True), ((2, 4), False),
                                          ((4, 2), False)])
def test_dist2d_spmv(rng, grid, realign):
    from libhpc_tpu.parallel.dist2d import Dist2DCSR, dist2d_spmv_fn

    pr, pc = grid
    mesh = jax.make_mesh((pr, pc), ("py", "px"),
                         devices=jax.devices()[: pr * pc])
    A = poisson2d(16)  # 256×256
    dA = Dist2DCSR.from_scipy(A, grid).shard(mesh)
    x = rng.random(dA.shape[1]).astype(np.float32)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("px")))
    got = np.asarray(dist2d_spmv_fn(dA, mesh, realign=realign)(xs))
    np.testing.assert_allclose(got, A @ x[: A.shape[0]], rtol=1e-4,
                               atol=1e-4)


@needs_8
def test_dist2d_cg(rng):
    """CG over the 2D-partitioned operator (realigned output feeds back)."""
    from libhpc_tpu.parallel.dist2d import Dist2DCSR, dist2d_spmv_fn
    from libhpc_tpu.ops.solver import cg

    mesh = jax.make_mesh((2, 2), ("py", "px"), devices=jax.devices()[:4])
    A = poisson2d(16)
    dA = Dist2DCSR.from_scipy(A, (2, 2)).shard(mesh)
    matvec = dist2d_spmv_fn(dA, mesh, realign=True)
    x_true = rng.random(A.shape[0]).astype(np.float32)
    b = jax.device_put(jnp.asarray(A @ x_true),
                       NamedSharding(mesh, P("px")))
    x, it, _ = cg(matvec, b, tol=1e-5, max_iter=2000)
    assert int(it) < 2000
    np.testing.assert_allclose(np.asarray(x), x_true, rtol=1e-2, atol=1e-2)


@needs_8
def test_dist_poisson_2dmesh(rng):
    from libhpc_tpu.ops.stencil import poisson5_apply
    from libhpc_tpu.parallel.dist_stencil import dist_poisson_2dmesh_fn

    mesh = jax.make_mesh((2, 4), ("py", "px"))
    u = rng.random((32, 64)).astype(np.float32)
    f = dist_poisson_2dmesh_fn(mesh)
    us = jax.device_put(jnp.asarray(u),
                        NamedSharding(mesh, P("py", "px")))
    got = np.asarray(f(us))
    np.testing.assert_allclose(
        got, np.asarray(poisson5_apply(jnp.asarray(u))), rtol=1e-4,
        atol=1e-4)
