"""Radix sort tests — stage-by-stage CPU oracles (the reference's
cpu_global_base_ref / cpu_local_count_ref / cpu_local_offset_ref pattern,
tests/test_radixsort_gpu_global_offset/src/cpu.cpp:3-49) plus end-to-end
is_sorted property tests (§4.2)."""

import numpy as np
import pytest
import jax.numpy as jnp

from conftest import EDGE_SIZES
from libhpc_tpu.ops import sort as srt


# ---- CPU oracles (tiny scalar references, like the reference's cpu.cpp) ----

def cpu_digit(x, shift, bits=8):
    return (x >> shift) & ((1 << bits) - 1)


def cpu_local_count(digits, n_bins, tile):
    n_tiles = max(1, -(-len(digits) // tile))
    out = np.zeros((n_tiles, n_bins), np.int32)
    for i, d in enumerate(digits):
        out[i // tile, d] += 1
    return out


def cpu_global_base(local):
    totals = local.sum(axis=0)
    return np.cumsum(totals) - totals


def cpu_local_offset(local):
    return np.cumsum(local, axis=0) - local


# ---- stage tests -----------------------------------------------------------

@pytest.mark.parametrize("n", [1, 111, 500, 3987, 100000])
def test_stage_local_count(rng, n):
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    digits = np.asarray(srt.digit_of(jnp.asarray(x), jnp.uint32(8)))
    got = np.asarray(srt.tile_histograms(jnp.asarray(digits), tile=2048))
    np.testing.assert_array_equal(got, cpu_local_count(digits, 256, 2048))


@pytest.mark.parametrize("n", [1, 111, 500, 3987, 100000])
def test_stage_global_base(rng, n):
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    digits = np.asarray(srt.digit_of(jnp.asarray(x), jnp.uint32(0)))
    local = srt.tile_histograms(jnp.asarray(digits), tile=2048)
    got = np.asarray(srt.global_base_from_local(local))
    np.testing.assert_array_equal(got, cpu_global_base(np.asarray(local)))


@pytest.mark.parametrize("n", [1, 111, 500, 3987, 100000])
def test_stage_local_offset(rng, n):
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    digits = np.asarray(srt.digit_of(jnp.asarray(x), jnp.uint32(16)))
    local = srt.tile_histograms(jnp.asarray(digits), tile=2048)
    got = np.asarray(srt.tile_offsets_from_local(local))
    np.testing.assert_array_equal(got, cpu_local_offset(np.asarray(local)))


def test_stage_rank_within_tiles(rng):
    digits = np.array([3, 1, 3, 3, 1, 0, 2, 2], np.int32)
    got = np.asarray(srt._rank_within_tiles(jnp.asarray(digits), n_bins=4,
                                            tile=4))
    # tiles: [3,1,3,3] -> ranks [0,0,1,2]; [1,0,2,2] -> [0,0,0,1]
    np.testing.assert_array_equal(got, [0, 0, 1, 2, 0, 0, 0, 1])


# ---- end-to-end property tests (§4.2) --------------------------------------

@pytest.mark.parametrize("n", EDGE_SIZES)
def test_sort_u32(rng, n):
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    got = np.asarray(srt.sort_u32(jnp.asarray(x)))
    assert bool(srt.is_sorted(jnp.asarray(got)))
    np.testing.assert_array_equal(got, np.sort(x))


@pytest.mark.parametrize("n", [1, 111, 256, 297, 500, 512, 3987, 50000])
def test_radix_pipeline(rng, n):
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    got = np.asarray(srt.radix_sort_pipeline(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.sort(x))


def test_radix_pipeline_extremes():
    x = np.array([0, 0xFFFFFFFF, 1, 0xFFFFFFFE, 0, 7], np.uint32)
    got = np.asarray(srt.radix_sort_pipeline(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.sort(x))


def test_argsort_stable(rng):
    x = rng.integers(0, 4, size=1000).astype(np.uint32)
    s, order = srt.argsort_u32(jnp.asarray(x))
    order = np.asarray(order)
    s = np.asarray(s)
    assert (np.diff(s) >= 0).all()
    # stability: equal keys keep original relative order
    for v in range(4):
        idx = order[s == v]
        assert (np.diff(idx) > 0).all()


@pytest.mark.slow
def test_sort_10m(rng):
    """The reference CPU-test scale (10M, test_radixsort_v1.cc:5-12)."""
    x = rng.integers(0, 1 << 32, size=10_000_000, dtype=np.uint32)
    got = srt.sort_u32(jnp.asarray(x))
    assert bool(srt.is_sorted(got))


@pytest.mark.parametrize("n", [1, 2, 111, 256, 1024, 3987, 8192])
def test_bitonic_sort(rng, n):
    x = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    got = np.asarray(srt.bitonic_sort(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.sort(x))


def test_bitonic_extremes():
    x = np.array([0xFFFFFFFF, 0, 0xFFFFFFFF, 5, 0], np.uint32)
    got = np.asarray(srt.bitonic_sort(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.sort(x))


# ---- adversarial sort cases (edge sizes, multi-level and segmented
# sizes, extreme and repeated values) through the production sort_u32 ----

def _sort_case(name, rng):
    u = lambda n: rng.integers(0, 2**32, size=n, dtype=np.uint32)
    if name.startswith("n"):
        return u(int(name[1:]))
    if name in ("extremes", "segmented_extremes"):
        x = u(2048 if name == "extremes" else 5120)
        x[:100] = 0
        x[100:200] = 0xFFFFFFFF
        x[200:300] = 0x7FFFFFFF      # i32 sign boundary
        x[300:400] = 0x80000000
        return x
    if name == "all_equal":
        return np.full(4096, 0xDEADBEEF, np.uint32)
    if name == "two_values":
        return rng.choice(np.array([7, 2**31], np.uint32), size=4096)
    x = np.sort(u(4096))
    return x if name == "presorted" else x[::-1].copy()


SORT_CASES = ["n1024", "n2048", "n4096", "n8192", "n3149", "n3000",
              "n5120", "n5137", "n9216", "n9300", "n11264", "n11300",
              "extremes", "segmented_extremes", "all_equal", "two_values",
              "presorted", "reversed"]


@pytest.mark.parametrize("name", SORT_CASES)
def test_sort_u32_cases(rng, name):
    x = _sort_case(name, rng)
    got = np.asarray(srt.sort_u32(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.sort(x))


@pytest.mark.parametrize("name", ["n1", "n111", "n512", "n3987",
                                  "two_values", "all_equal"])
def test_argsort_u32_cases(rng, name):
    """Sorted keys, and an order that is exactly numpy's stable argsort
    (a permutation that keeps equal keys in input order)."""
    x = _sort_case(name, rng)
    s, order = srt.argsort_u32(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(s), np.sort(x))
    np.testing.assert_array_equal(np.asarray(order),
                                  np.argsort(x, kind="stable"))
