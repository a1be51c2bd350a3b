"""Native host-runtime tests (mempool / threadpool / MPMC queue /
hierarchical lock / MatrixMarket loader) — the host-runtime equivalents of the
reference's concurrency + mempool suites (SURVEY.md §4.3-4.4).

Skipped gracefully if no C++ toolchain is available.
"""

import os
import numpy as np
import pytest
import scipy.sparse as sps
import scipy.io as sio

native = pytest.importorskip("libhpc_tpu.runtime.native")

try:
    native.get_lib()
    HAVE_NATIVE = True
except Exception:
    HAVE_NATIVE = False

pytestmark = pytest.mark.skipif(not HAVE_NATIVE,
                                reason="native toolchain unavailable")


def test_selftest():
    """Runs the in-process stress matrix: MPMC queue 1×1/2×4/3×2 producer/
    consumer tallies, arena pool (alignment, large-free, LIFO cleanups),
    hierarchical lock order enforcement, threadpool parallel_for sum."""
    assert native.selftest() == 0


def test_pool_lifecycle():
    p = native.ArenaPool(page_size=4096)
    ptrs = [p.alloc(100) for _ in range(100)]
    assert all(ptr % 16 == 0 for ptr in ptrs)
    assert p.n_pages >= 1
    big = p.alloc(1 << 16)
    assert p.free_large(big)
    p.reset()
    assert p.n_pages >= 1
    p.close()


@pytest.mark.parametrize("kind", ["general", "symmetric", "pattern"])
def test_mtx_loader(tmp_path, rng, kind):
    n = 60
    if kind == "symmetric":
        A = sps.random(n, n, density=0.1, format="coo", dtype=np.float64,
                       random_state=np.random.RandomState(1))
        A = (A + A.T).tocoo()  # symmetric
        expect = A.tocsr()
    elif kind == "pattern":
        A = sps.random(n, n, density=0.1, format="coo", dtype=np.float64,
                       random_state=np.random.RandomState(2))
        A.data[:] = 1.0
        expect = A.tocsr()
    else:
        A = sps.random(n, n, density=0.1, format="coo", dtype=np.float64,
                       random_state=np.random.RandomState(3))
        expect = A.tocsr()

    path = tmp_path / f"{kind}.mtx"
    if kind == "symmetric":
        sio.mmwrite(str(path), sps.tril(A), symmetry="symmetric")
    elif kind == "pattern":
        sio.mmwrite(str(path), A, field="pattern")
    else:
        sio.mmwrite(str(path), A)

    got = native.load_mtx_native(str(path))
    assert got.shape == expect.shape
    np.testing.assert_allclose(got.toarray(), expect.toarray().astype(np.float32),
                               rtol=1e-5, atol=1e-6)


def test_mtx_loader_large_parallel(tmp_path):
    """Multi-chunk parse: enough lines that every pool thread gets a span."""
    n = 2000
    A = sps.random(n, n, density=0.01, format="coo", dtype=np.float64,
                   random_state=np.random.RandomState(4))
    path = tmp_path / "big.mtx"
    sio.mmwrite(str(path), A)
    got = native.load_mtx_native(str(path), n_threads=4)
    expect = A.tocsr()
    assert got.nnz == expect.nnz
    np.testing.assert_allclose(got.toarray(),
                               expect.toarray().astype(np.float32),
                               rtol=1e-5, atol=1e-6)
    # canonical CSR: sorted column indices per row
    for r in range(0, n, 97):
        s, e = got.indptr[r], got.indptr[r + 1]
        assert (np.diff(got.indices[s:e]) > 0).all()


def test_morton_host_matches_jax(rng):
    import jax.numpy as jnp
    from libhpc_tpu.utils.morton import morton2d_encode

    x = rng.integers(0, 1 << 16, 1000).astype(np.uint32)
    y = rng.integers(0, 1 << 16, 1000).astype(np.uint32)
    got = native.morton2d_encode_host(x, y)
    expect = np.asarray(morton2d_encode(jnp.asarray(x), jnp.asarray(y)))
    np.testing.assert_array_equal(got, expect)


@pytest.mark.slow
def test_asan_selftest():
    """Build + run the concurrency selftest under ASan+LSan — the
    reference's sanitizer policy (tests/CMakeLists.txt:6-9) applied to the
    library's host runtime."""
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ndir = os.path.join(root, "native")
    subprocess.run(["make", "-C", ndir, "asan"], check=True,
                   capture_output=True)
    out = subprocess.run([os.path.join(ndir, "build", "selftest_asan")],
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr


def test_bench_counter_ordering():
    """Sanity: unsynchronized increments are cheapest; contended primitives
    cost more (the reference's qualitative finding). min-of-3 to keep the
    comparison robust on a noisy 2-core container."""
    unsync = min(native.bench_counter(0, threads=2, iters=200_000)
                 for _ in range(3))
    atomic = min(native.bench_counter(1, threads=2, iters=200_000)
                 for _ in range(3))
    assert unsync < atomic


def test_matrix_dir_bench_path_end_to_end(tmp_path, monkeypatch):
    """The bench loading path: a real .mtx under
    $LIBHPC_MATRIX_DIR must flow through load_or_synthesize -> native
    loader -> the SpMV bench containers, bit-identical across thread
    counts, instead of falling back to the synthetic stand-in."""
    from libhpc_tpu.bench import matrices

    n = 400
    A = sps.random(n, n, density=0.05, format="coo", dtype=np.float64,
                   random_state=np.random.RandomState(11))
    A.setdiag(2.0)
    sio.mmwrite(str(tmp_path / "cant.mtx"), A)
    monkeypatch.setenv("LIBHPC_MATRIX_DIR", str(tmp_path))

    got = matrices.load_or_synthesize("cant")
    assert got.shape == (n, n)          # the file, not the 62k stand-in
    expect = A.tocsr().astype(np.float32)
    np.testing.assert_allclose(got.toarray(), expect.toarray(),
                               rtol=1e-5, atol=1e-6)

    # thread-count invariance of the parallel parse (reference §4.3 style)
    g1 = native.load_mtx_native(str(tmp_path / "cant.mtx"), n_threads=1)
    g4 = native.load_mtx_native(str(tmp_path / "cant.mtx"), n_threads=4)
    assert (g1.indptr == g4.indptr).all()
    assert (g1.indices == g4.indices).all()
    np.testing.assert_array_equal(g1.data, g4.data)

    # and the loaded matrix drives the flagship SpMV path correctly
    import jax.numpy as jnp

    from libhpc_tpu.ops.spmv_pallas import sbell_spmv
    from libhpc_tpu.sparse.sbell import SBELL

    sb = SBELL.from_scipy(got)
    x = np.linspace(-1, 1, n).astype(np.float32)
    y = np.asarray(sbell_spmv(sb, jnp.asarray(x)))
    np.testing.assert_allclose(y, got @ x, rtol=1e-4, atol=1e-5)
