"""unique / Table.distinct: exact values + counts vs np.unique, across
dtypes, duplication levels, and the sentinel/padding edge cases.
"""

import numpy as np
import pytest

from radx_tpu.ops.distinct import unique



@pytest.mark.parametrize("n", [1, 2, 100, 2048, 8000])
def test_unique_uint32(rng, n):
    keys = rng.integers(0, max(2, n // 3), n, dtype=np.uint32)
    vals, count = unique(keys)
    count = int(count)
    np.testing.assert_array_equal(
        np.asarray(vals)[:count], np.unique(keys)
    )


def test_unique_counts(rng):
    n = 4000
    keys = rng.integers(0, 997, n, dtype=np.uint32)
    vals, counts, count = unique(keys, return_counts=True)
    count = int(count)
    ev, ec = np.unique(keys, return_counts=True)
    np.testing.assert_array_equal(np.asarray(vals)[:count], ev)
    np.testing.assert_array_equal(np.asarray(counts)[:count], ec)


def test_unique_all_distinct_and_all_equal(rng):
    keys = rng.permutation(2000).astype(np.uint32)
    vals, count = unique(keys)
    assert int(count) == 2000
    np.testing.assert_array_equal(
        np.asarray(vals)[:2000], np.arange(2000, dtype=np.uint32)
    )
    keys = np.full(2000, 42, np.uint32)
    vals, counts, count = unique(keys, return_counts=True)
    assert int(count) == 1
    assert int(np.asarray(vals)[0]) == 42
    assert int(np.asarray(counts)[0]) == 2000


def test_unique_sentinel_key(rng):
    # 0xFFFFFFFF is the padding sentinel: must appear exactly once with an
    # exact count even when pads tie with it
    n = 3000
    keys = rng.integers(0, 50, n, dtype=np.uint32)
    keys[100:200] = 0xFFFFFFFF
    vals, counts, count = unique(keys, return_counts=True)
    count = int(count)
    ev, ec = np.unique(keys, return_counts=True)
    np.testing.assert_array_equal(np.asarray(vals)[:count], ev)
    np.testing.assert_array_equal(np.asarray(counts)[:count], ec)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_unique_dtypes(rng, dtype):
    n = 4000
    if dtype == np.int32:
        keys = rng.integers(-500, 500, n).astype(np.int32)
    else:
        keys = (rng.integers(-40, 40, n) / 8.0).astype(np.float32)
    vals, counts, count = unique(keys, return_counts=True)
    count = int(count)
    ev, ec = np.unique(keys, return_counts=True)
    np.testing.assert_array_equal(np.asarray(vals)[:count], ev)
    np.testing.assert_array_equal(np.asarray(counts)[:count], ec)


def test_table_distinct(rng):
    from radx_tpu.ops.table import Table

    n = 2048
    key = rng.integers(0, 300, n, dtype=np.uint32)
    val = np.arange(n, dtype=np.int32)
    t = Table.from_arrays(k=key, v=val).distinct("k")
    ev = np.unique(key)
    np.testing.assert_array_equal(np.asarray(t.column("k")), ev)
    # first-occurrence semantics: v must be the earliest row of each key
    first_rows = np.array(
        [np.flatnonzero(key == u)[0] for u in ev], dtype=np.int32
    )
    np.testing.assert_array_equal(np.asarray(t.column("v")), first_rows)
