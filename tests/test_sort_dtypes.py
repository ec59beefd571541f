"""Wider key dtypes: int32 / float32 / descending / 64-bit — capabilities
beyond the reference's uint32-only surface."""

import numpy as np
import pytest

from radx_tpu.ops import sort as sort_mod



def test_sort_int32(rng):
    k = rng.integers(-(2**31), 2**31, 20000, dtype=np.int32)
    got = np.asarray(sort_mod.sort_any(k))
    np.testing.assert_array_equal(got, np.sort(k))


def test_sort_float32(rng):
    k = np.concatenate(
        [
            rng.normal(size=5000).astype(np.float32) * 1e20,
            np.array([0.0, -0.0, np.inf, -np.inf], np.float32),
            rng.normal(size=5000).astype(np.float32),
        ]
    )
    got = np.asarray(sort_mod.sort_any(k))
    np.testing.assert_array_equal(got, np.sort(k))


def test_sort_float32_nan_last(rng):
    k = np.array([3.0, np.nan, -1.0, 2.0], np.float32)
    got = np.asarray(sort_mod.sort_any(k))
    assert np.isnan(got[-1]) and np.array_equal(got[:3], [-1.0, 2.0, 3.0])


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_descending(rng, dtype):
    if dtype == np.float32:
        k = rng.normal(size=8000).astype(dtype)
    else:
        k = rng.integers(0, 1000, 8000).astype(dtype)
    got = np.asarray(sort_mod.sort_any(k, descending=True))
    np.testing.assert_array_equal(got, np.sort(k)[::-1])


def test_sort_pairs_any_stable(rng):
    k = rng.integers(-50, 50, 10000, dtype=np.int32)
    p = np.arange(10000, dtype=np.uint32)
    sk, sp = sort_mod.sort_pairs_any(k, p)
    np.testing.assert_array_equal(np.asarray(sp), np.argsort(k, kind="stable"))
    np.testing.assert_array_equal(np.asarray(sk), np.sort(k))


def test_sort_u64(rng):
    n = 20000
    full = rng.integers(0, 2**64, n, dtype=np.uint64)
    hi = (full >> 32).astype(np.uint32)
    lo = full.astype(np.uint32)
    sh, sl = sort_mod.sort_u64(hi, lo)
    got = (np.asarray(sh).astype(np.uint64) << 32) | np.asarray(sl)
    np.testing.assert_array_equal(got, np.sort(full))


@pytest.mark.parametrize("dtype", [np.uint64, np.int64, np.float64])
def test_sort_any_64bit(rng, dtype):
    n = 20000
    if dtype == np.float64:
        k = np.concatenate(
            [
                rng.normal(size=n // 2) * 1e300,
                np.array([0.0, np.inf, -np.inf]),
                rng.normal(size=n // 2 - 3),
            ]
        )
    elif dtype == np.int64:
        k = rng.integers(-(2**63), 2**63, n, dtype=np.int64)
    else:
        k = rng.integers(0, 2**64, n, dtype=np.uint64)
    got = sort_mod.sort_any(k)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, np.sort(k))


@pytest.mark.parametrize("dtype", [np.uint64, np.int64, np.float64])
def test_sort_any_64bit_descending(rng, dtype):
    n = 8000
    if dtype == np.float64:
        k = rng.normal(size=n) * 1e300
    else:
        k = rng.integers(-(2**62), 2**62, n).astype(dtype)
    got = sort_mod.sort_any(k, descending=True)
    np.testing.assert_array_equal(got, np.sort(k)[::-1])


def test_sort_any_float64_nan_last(rng):
    k = np.array([3.0, np.nan, -1.0, 2.0, -0.0], np.float64)
    got = sort_mod.sort_any(k)
    assert np.isnan(got[-1])
    np.testing.assert_array_equal(got[:4], np.array([-1.0, -0.0, 2.0, 3.0]))


@pytest.mark.parametrize("dtype", [np.uint64, np.int64, np.float64])
def test_sort_pairs_any_64bit_stable(rng, dtype):
    n = 12000
    if dtype == np.float64:
        k = np.concatenate(
            [
                rng.normal(size=n // 2) * 1e300,
                rng.integers(-5, 5, n // 2).astype(np.float64),
            ]
        )
    else:
        # low-entropy front half forces duplicate keys (stability matters)
        k = rng.integers(-(2**62), 2**62, n).astype(dtype)
        k[: n // 2] = rng.integers(0, 8, n // 2).astype(dtype)
    p = np.arange(n, dtype=np.uint32)
    sk, sp = sort_mod.sort_pairs_any(k, p)
    order = np.argsort(sort_mod._encode_keys64(k), kind="stable")
    assert sk.dtype == dtype
    np.testing.assert_array_equal(sk, k[order])
    np.testing.assert_array_equal(np.asarray(sp), order.astype(np.uint32))


def test_sort_pairs_any_64bit_descending(rng):
    n = 4096
    k = rng.integers(0, 16, n, dtype=np.uint64)  # heavy duplicates
    p = np.arange(n, dtype=np.uint32)
    sk, sp = sort_mod.sort_pairs_any(k, p, descending=True)
    order = np.argsort(~sort_mod._encode_keys64(k), kind="stable")
    np.testing.assert_array_equal(sk, k[order])
    np.testing.assert_array_equal(np.asarray(sp), order.astype(np.uint32))
