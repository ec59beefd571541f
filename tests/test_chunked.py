"""Chunked (streaming) operators — semantics must match the one-call ops."""

import numpy as np
import pytest

from radx_tpu.ops.chunked import filter_chunked, groupby_chunked



def test_filter_chunked_matches_numpy():
    rng = np.random.default_rng(0)
    n = 40000
    mask = (rng.random(n) < 0.3).astype(np.int32)
    a = rng.integers(0, 2**32, n, dtype=np.uint32)
    b = rng.random(n).astype(np.float32)
    (ga, gb), cnt = filter_chunked(mask, [a, b], slab=9000)
    keep = mask != 0
    assert cnt == int(keep.sum())
    np.testing.assert_array_equal(ga, a[keep])
    np.testing.assert_array_equal(gb, b[keep])


def test_filter_chunked_empty_and_full():
    n = 5000
    a = np.arange(n, dtype=np.uint32)
    (ga,), cnt = filter_chunked(np.zeros(n, np.int32), [a], slab=2000)
    assert cnt == 0 and ga.shape[0] == 0
    (ga,), cnt = filter_chunked(np.ones(n, np.int32), [a], slab=2000)
    assert cnt == n
    np.testing.assert_array_equal(ga, a)


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
def test_groupby_chunked_matches_numpy(agg):
    rng = np.random.default_rng(1)
    n = 30000
    keys = rng.integers(0, 200, n, dtype=np.uint32)
    vals = rng.integers(0, 1000, n, dtype=np.int64).astype(np.int32)
    uk, out, ng = groupby_chunked(keys, vals, agg, slab=7000)
    want_k = np.unique(keys)
    assert ng == want_k.shape[0]
    np.testing.assert_array_equal(uk, want_k)
    for j, k in enumerate(want_k):
        v = vals[keys == k]
        want = {
            "sum": v.sum(dtype=np.int64) & 0xFFFFFFFF,
            "count": v.shape[0],
            "min": v.min(),
            "max": v.max(),
        }[agg]
        got = int(out[j]) & 0xFFFFFFFF if agg == "sum" else int(out[j])
        assert got == want, (agg, k, got, want)


def test_groupby_chunked_high_cardinality_host_merge():
    """All-unique keys: the recursion guard routes to the exact host merge."""
    rng = np.random.default_rng(2)
    n = 20000
    keys = rng.permutation(n).astype(np.uint32)
    vals = rng.integers(0, 1000, n, dtype=np.int64).astype(np.int32)
    uk, out, ng = groupby_chunked(keys, vals, "sum", slab=5000)
    assert ng == n
    order = np.argsort(keys)
    np.testing.assert_array_equal(uk, keys[order])
    np.testing.assert_array_equal(out, vals[order])


def test_sort_chunked_matches_npsort(rng):
    from radx_tpu.ops.chunked import sort_chunked

    n = 40_000  # several 8192-elem slabs + ragged tail
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    got = sort_chunked(keys, slab=8192)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sort_chunked_single_slab(rng):
    from radx_tpu.ops.chunked import sort_chunked

    keys = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    got = sort_chunked(keys, slab=8192)
    np.testing.assert_array_equal(got, np.sort(keys))
