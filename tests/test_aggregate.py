"""Dense aggregate (ops/groupby.dense_aggregate + groupby_dense) vs NumPy
reference semantics."""

import functools

import jax
import numpy as np
import pytest

from radx_tpu.ops import groupby as groupby_ops
from radx_tpu.ops.groupby import groupby_dense


@functools.partial(jax.jit, static_argnames=("bins", "agg"))
def _dense(keys, vals, bins, agg):
    return groupby_ops.dense_aggregate(keys, vals, bins, agg)


@pytest.mark.parametrize("bins,n", [(128, 3000), (1024, 20000), (65536, 8192)])
def test_dense_sums_match_numpy(rng, bins, n):
    keys = rng.integers(0, bins, n, dtype=np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    sums, counts = _dense(keys, vals, bins, "sum")
    want_counts = np.bincount(keys, minlength=bins).astype(np.int32)
    want_sums = np.zeros(bins, np.uint64)
    np.add.at(want_sums, keys, vals.astype(np.uint64))
    np.testing.assert_array_equal(np.asarray(counts), want_counts)
    np.testing.assert_array_equal(
        np.asarray(sums), (want_sums & 0xFFFFFFFF).astype(np.uint32)
    )


def test_dense_sums_nonaligned_tail(rng):
    # odd n, every row in bin 0: nothing else may contribute.
    n, bins = 4097, 256
    keys = np.zeros(n, np.uint32)
    vals = np.ones(n, np.uint32)
    sums, counts = _dense(keys, vals, bins, "sum")
    assert int(counts[0]) == n
    assert int(sums[0]) == n


@pytest.mark.parametrize("agg", ["sum", "count"])
def test_groupby_dense_matches_groupby(rng, agg):
    n, bins = 20000, 512
    keys = rng.integers(0, 500, n, dtype=np.uint32)
    vals = rng.integers(0, 1000, n, dtype=np.uint32)
    uk, out, ng = groupby_dense(keys, vals, agg, bins=bins)
    ng = int(ng)
    uniq = np.unique(keys)
    assert ng == uniq.size
    np.testing.assert_array_equal(np.asarray(uk)[:ng], uniq)
    ref = {
        "sum": lambda m: vals[m].sum(dtype=np.uint32),
        "count": lambda m: m.sum(),
    }[agg]
    got = np.asarray(out)[:ng]
    want = np.array([ref(keys == u) for u in uniq], dtype=got.dtype)
    np.testing.assert_array_equal(got, want)


def test_groupby_dense_int32_values(rng):
    n = 5000
    keys = rng.integers(0, 128, n, dtype=np.uint32)
    vals = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    uk, out, ng = groupby_dense(keys, vals, "sum", bins=128)
    ng = int(ng)
    uniq = np.unique(keys)
    want = np.array(
        [vals[keys == u].astype(np.int64).sum() & 0xFFFFFFFF for u in uniq],
        dtype=np.uint64,
    ).astype(np.uint32)
    got = np.asarray(out)[:ng].view(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_groupby_dense_rejects_out_of_range(rng):
    keys = np.array([0, 5, 999], np.uint32)
    vals = np.ones(3, np.uint32)
    with pytest.raises(ValueError, match="requires every key"):
        groupby_dense(keys, vals, "sum", bins=128)


def test_groupby_dense_validation():
    k = np.zeros(4, np.uint32)
    v = np.zeros(4, np.uint32)
    with pytest.raises(ValueError):
        groupby_dense(k, v, "min", bins=0)
    with pytest.raises(ValueError):
        groupby_dense(k, v, "sum", bins=(1 << 24) + 1)
    with pytest.raises(ValueError):
        groupby_dense(k, v, "median", bins=128)
    # int32 bin ids are accepted (bitcast identity in range); float32 keys
    # stay rejected
    uk_i, _, ng_i = groupby_dense(k.astype(np.int32), v, "sum", bins=128)
    assert uk_i.dtype == np.int32 and int(ng_i) == 1
    with pytest.raises(TypeError):
        groupby_dense(k.astype(np.float32), v, "sum", bins=128)
    with pytest.raises(TypeError):
        groupby_dense(k, v.astype(np.int16), "sum", bins=128)
    # float32 sums are accepted (unspecified summation order, like groupby)
    _, out_f, _ = groupby_dense(k, v.astype(np.float32) + 1.5, "sum", bins=8)
    assert float(out_f[0]) == 6.0
    uk, out, ng = groupby_dense(
        np.zeros(0, np.uint32), np.zeros(0, np.uint32), "sum"
    )
    assert int(ng) == 0


@pytest.mark.parametrize("bins,n", [(128, 3000), (1024, 20000)])
@pytest.mark.parametrize("is_min", [True, False])
def test_dense_extrema_match_numpy(rng, bins, n, is_min):
    keys = rng.integers(0, bins, n, dtype=np.uint32)
    vals = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    ext, counts = _dense(keys, vals, bins, "min" if is_min else "max")
    want_counts = np.bincount(keys, minlength=bins).astype(np.int32)
    np.testing.assert_array_equal(np.asarray(counts), want_counts)
    fold = np.minimum if is_min else np.maximum
    ident = np.int32(2**31 - 1) if is_min else np.int32(-(2**31))
    want = np.full(bins, ident, np.int32)
    fold.at(want, keys, vals)
    np.testing.assert_array_equal(np.asarray(ext), want)


@pytest.mark.parametrize("agg", ["min", "max"])
@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
def test_groupby_dense_minmax_matches_groupby(rng, agg, dtype):
    from radx_tpu.ops.groupby import groupby

    n, bins = 20000, 512
    keys = rng.integers(0, 500, n, dtype=np.uint32)
    if dtype == np.float32:
        vals = rng.normal(size=n).astype(np.float32)
    elif dtype == np.int32:
        vals = rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)
    else:
        vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    uk, out, ng = groupby_dense(keys, vals, agg, bins=bins)
    suk, sout, sng = groupby(keys, vals, agg)
    ng, sng = int(ng), int(sng)
    assert ng == sng
    np.testing.assert_array_equal(np.asarray(uk)[:ng], np.asarray(suk)[:sng])
    np.testing.assert_array_equal(
        np.asarray(out)[:ng], np.asarray(sout)[:sng]
    )
    # and vs plain numpy
    uniq = np.unique(keys)
    fold = np.min if agg == "min" else np.max
    want = np.array([fold(vals[keys == u]) for u in uniq], dtype=dtype)
    np.testing.assert_array_equal(np.asarray(out)[:ng], want)


def test_groupby_dense_extreme_value_edges(rng):
    # identity-colliding values: min == INT32_MAX-equivalent patterns must
    # still surface (presence comes from counts, not from the identity).
    keys = np.array([0, 0, 3, 3], np.uint32)
    vals = np.array([0xFFFFFFFF, 0xFFFFFFFF, 0, 0xFFFFFFFF], np.uint32)
    uk, out, ng = groupby_dense(keys, vals, "max", bins=128)
    assert int(ng) == 2
    np.testing.assert_array_equal(
        np.asarray(out)[:2], np.array([0xFFFFFFFF, 0xFFFFFFFF], np.uint32)
    )
    uk, out, ng = groupby_dense(keys, vals, "min", bins=128)
    np.testing.assert_array_equal(
        np.asarray(out)[:2], np.array([0xFFFFFFFF, 0], np.uint32)
    )
