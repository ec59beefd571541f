"""top_k selection operator: exact (value, index) order vs a NumPy model,
across dtypes, duplication levels and k edge cases.
"""

import numpy as np
import pytest

from radx_tpu.ops import core
from radx_tpu.ops.topk import top_k



def _np_topk(keys, k, largest):
    enc = np.asarray(core.encode_keys(keys)).astype(np.uint64)
    order = np.argsort(~enc if largest else enc, kind="stable")
    idx = order[:k].astype(np.int32)
    return keys[idx], idx


@pytest.mark.parametrize("largest", [True, False])
@pytest.mark.parametrize("k", [1, 129, 500])
def test_topk_uint32(rng, k, largest):
    n = 3000
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    vals, idx = top_k(keys, k, largest)
    ev, ei = _np_topk(keys, k, largest)
    np.testing.assert_array_equal(np.asarray(vals), ev)
    np.testing.assert_array_equal(np.asarray(idx), ei)


def test_topk_duplicates_tie_order(rng):
    # heavy duplication: ties must resolve to the smallest original index
    n = 2048
    keys = rng.integers(0, 7, n, dtype=np.uint32)
    for largest in (True, False):
        vals, idx = top_k(keys, 300, largest)
        ev, ei = _np_topk(keys, 300, largest)
        np.testing.assert_array_equal(np.asarray(vals), ev)
        np.testing.assert_array_equal(np.asarray(idx), ei)


@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_topk_signed_and_float(rng, dtype):
    n = 3000
    if dtype == np.int32:
        keys = rng.integers(-(2**31), 2**31, n).astype(np.int32)
    else:
        keys = rng.normal(size=n).astype(np.float32)
        keys[::97] = -keys[::97]
        keys[17] = np.float32(np.inf)
        keys[18] = np.float32(-np.inf)
        keys[19] = np.float32(0.0)
        keys[20] = np.float32(-0.0)
    for largest in (True, False):
        vals, idx = top_k(keys, 200, largest)
        ev, ei = _np_topk(keys, 200, largest)
        np.testing.assert_array_equal(np.asarray(idx), ei)
        np.testing.assert_array_equal(
            np.asarray(vals).view(np.uint32), ev.view(np.uint32)
        )


def test_topk_k_equals_n(rng):
    # k == n forces the full-sort path: result is the whole stable order
    n = 1500
    keys = rng.integers(0, 1000, n, dtype=np.uint32)
    vals, idx = top_k(keys, n, True)
    ev, ei = _np_topk(keys, n, True)
    np.testing.assert_array_equal(np.asarray(vals), ev)
    np.testing.assert_array_equal(np.asarray(idx), ei)


def test_topk_nonpow2_padding(rng):
    # padding rows must never surface, even when k is close to n
    n = 1025
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    vals, idx = top_k(keys, 1000, True)
    ev, ei = _np_topk(keys, 1000, True)
    np.testing.assert_array_equal(np.asarray(vals), ev)
    np.testing.assert_array_equal(np.asarray(idx), ei)
    assert int(np.asarray(idx).max()) < n


def test_topk_k_validation(rng):
    keys = rng.integers(0, 100, 10, dtype=np.uint32)
    with pytest.raises(ValueError):
        top_k(keys, 0)
    with pytest.raises(ValueError):
        top_k(keys, 11)


def test_topk_matches_lax_top_k(rng):
    # int32 keys with duplicates: same values and tie order as lax.top_k
    import jax

    n = 20000
    keys = rng.integers(-(2**20), 2**20, n).astype(np.int32)
    v1, i1 = top_k(keys, 333, True)
    v2, i2 = jax.lax.top_k(keys, 333)
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))


def test_table_topk(rng):
    from radx_tpu.ops.table import Table

    n = 2048
    key = rng.integers(0, 500, n, dtype=np.uint32)
    val = np.arange(n, dtype=np.int32)
    t = Table.from_arrays(k=key, v=val).top_k("k", 50)
    ev, ei = _np_topk(key, 50, True)
    np.testing.assert_array_equal(np.asarray(t.column("k")), ev)
    np.testing.assert_array_equal(np.asarray(t.column("v")), val[ei])
