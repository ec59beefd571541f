"""Relational operators (filter / groupby / join) vs NumPy reference
semantics — BASELINE configs 3-4 at correctness scale."""

import numpy as np
import pytest

from radx_tpu.ops.filter import filter_columns
from radx_tpu.ops.groupby import groupby
from radx_tpu.ops.join import join_inner


def test_filter_stable(rng):
    n = 10000
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    extra = rng.normal(size=n).astype(np.float32)
    mask = (vals % 3 == 0).astype(np.int32)
    (v_out, e_out), count = filter_columns(mask, [vals, extra])
    count = int(count)
    assert count == int(mask.sum())
    np.testing.assert_array_equal(np.asarray(v_out)[:count], vals[mask != 0])
    np.testing.assert_array_equal(np.asarray(e_out)[:count], extra[mask != 0])


def test_filter_all_and_none(rng):
    vals = rng.integers(0, 100, 1000, dtype=np.uint32)
    (out,), count = filter_columns(np.ones(1000, np.int32), [vals])
    assert int(count) == 1000
    np.testing.assert_array_equal(np.asarray(out), vals)
    (_, ), count = filter_columns(np.zeros(1000, np.int32), [vals])
    assert int(count) == 0


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
def test_groupby(rng, agg):
    n = 20000
    keys = rng.integers(0, 50, n, dtype=np.uint32) * 7919
    vals = rng.integers(0, 1000, n, dtype=np.uint32)
    uk, out, ng = groupby(keys, vals, agg)
    ng = int(ng)
    uniq = np.unique(keys)
    assert ng == uniq.size
    np.testing.assert_array_equal(np.asarray(uk)[:ng], uniq)
    ref = {
        "sum": lambda m: vals[m].sum(dtype=np.uint32),
        "count": lambda m: m.sum(),
        "min": lambda m: vals[m].min(),
        "max": lambda m: vals[m].max(),
    }[agg]
    got = np.asarray(out)[:ng]
    want = np.array([ref(keys == u) for u in uniq], dtype=got.dtype)
    np.testing.assert_array_equal(got, want)


def test_join_unique_keys(rng):
    nb, np_ = 5000, 3000
    bk = rng.permutation(100_000)[:nb].astype(np.uint32)
    bv = rng.integers(0, 2**32, nb, dtype=np.uint32)
    pk = np.concatenate([bk[:1500], (rng.integers(2**31, 2**32, np_ - 1500)).astype(np.uint32)])
    pv = np.arange(np_, dtype=np.uint32)
    k, bvo, pvo, valid, trunc = join_inner(bk, bv, pk, pv, max_matches=1)
    assert not bool(trunc)
    valid = np.asarray(valid)
    build_map = dict(zip(bk.tolist(), bv.tolist()))
    for i in range(np_):
        expect = pk[i].item() in build_map
        assert bool(valid[i, 0]) == expect, i
        if expect:
            assert np.asarray(bvo)[i, 0] == build_map[pk[i].item()]
            assert np.asarray(pvo)[i, 0] == pv[i]


def test_join_merge_matches_numpy(rng):
    from radx_tpu.ops.join import join_merge

    nb, npr = 4000, 6000
    bk = rng.permutation(20_000)[:nb].astype(np.uint32)
    bv = rng.integers(0, 2**32, nb, dtype=np.uint32)
    pk = rng.integers(0, 20_000, npr).astype(np.uint32)
    pv = np.arange(npr, dtype=np.uint32)
    k, b, p, count = join_merge(bk, bv, pk, pv)
    count = int(count)
    bmap = dict(zip(bk.tolist(), bv.tolist()))
    expect = sorted(
        (int(pk[i]), int(pv[i]), bmap[int(pk[i])])
        for i in range(npr)
        if int(pk[i]) in bmap
    )
    got = sorted(
        zip(
            np.asarray(k)[:count].tolist(),
            np.asarray(p)[:count].tolist(),
            np.asarray(b)[:count].tolist(),
        )
    )
    assert got == expect


def test_join_merge_duplicate_build_keys_last_wins(rng):
    from radx_tpu.ops.join import join_merge

    bk = np.array([7, 7, 9], np.uint32)
    bv = np.array([70, 71, 90], np.uint32)
    pk = np.array([7, 9, 8], np.uint32)
    pv = np.array([1, 2, 3], np.uint32)
    k, b, p, count = join_merge(bk, bv, pk, pv)
    count = int(count)
    rows = sorted(
        zip(np.asarray(k)[:count].tolist(), np.asarray(p)[:count].tolist(),
            np.asarray(b)[:count].tolist())
    )
    assert rows == [(7, 1, 71), (9, 2, 90)]


def test_join_duplicates(rng):
    bk = np.array([5, 5, 5, 9, 9, 1], dtype=np.uint32)
    bv = np.arange(6, dtype=np.uint32)
    pk = np.array([5, 9, 2], dtype=np.uint32)
    pv = np.array([100, 200, 300], dtype=np.uint32)
    k, bvo, pvo, valid, trunc = join_inner(bk, bv, pk, pv, max_matches=4)
    assert not bool(trunc)
    v = np.asarray(valid)
    assert v[0].sum() == 3 and v[1].sum() == 2 and v[2].sum() == 0
    assert set(np.asarray(bvo)[0][v[0]].tolist()) == {0, 1, 2}
    # truncation flag
    *_, trunc = join_inner(bk, bv, pk, pv, max_matches=2)
    assert bool(trunc)


@pytest.mark.parametrize("agg", ["min", "max"])
def test_groupby_int32_values(rng, agg):
    # ADVICE round 1: int32 min/max used wrong scan identities and a
    # 0xFFFFFFFF key sentinel that collides with a legal key value.
    n = 100
    keys = np.full(n, 0xFFFFFFFF, np.uint32)
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    uk, out, ng = groupby(keys, vals, agg)
    assert int(ng) == 1
    want = vals.min() if agg == "min" else vals.max()
    assert int(np.asarray(out)[0]) == want


@pytest.mark.parametrize("agg", ["sum", "min", "max"])
def test_groupby_float32_values(rng, agg):
    n = 5000
    keys = rng.integers(0, 37, n, dtype=np.uint32)
    vals = rng.normal(size=n).astype(np.float32)
    uk, out, ng = groupby(keys, vals, agg)
    ng = int(ng)
    uniq = np.unique(keys)
    assert ng == uniq.size
    got = np.asarray(out)[:ng]
    for i, u in enumerate(uniq):
        sel = vals[keys == u]
        if agg == "sum":
            assert np.isclose(got[i], sel.sum(dtype=np.float64), rtol=1e-4)
        elif agg == "min":
            assert got[i] == sel.min()
        else:
            assert got[i] == sel.max()


def test_groupby_mixed_keys_int32_min(rng):
    # several groups, negative int32 values, including the max-key group
    n = 1000
    keys = rng.choice(
        np.array([0, 5, 0xFFFFFFFF], np.uint32), size=n
    ).astype(np.uint32)
    vals = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    uk, out, ng = groupby(keys, vals, "min")
    ng = int(ng)
    uniq = np.unique(keys)
    np.testing.assert_array_equal(np.asarray(uk)[:ng], uniq)
    want = np.array([vals[keys == u].min() for u in uniq], np.int32)
    np.testing.assert_array_equal(np.asarray(out)[:ng], want)


def test_join_merge_multi_matches_numpy(rng):
    """Bounded multi-match scalable join: exact multiset of output rows and
    the truncation contract, vs a host reference."""
    import collections

    from radx_tpu.ops.join import join_merge_multi

    nb, np_ = 3000, 5000
    M = 6
    bk = rng.integers(0, 1200, nb, dtype=np.uint32)
    bv = rng.integers(0, 10**6, nb, dtype=np.int64).astype(np.int32)
    pk = rng.integers(0, 1500, np_, dtype=np.uint32)
    pv = rng.integers(0, 10**6, np_, dtype=np.int64).astype(np.int32)
    k, bvs, pvs, valid, trunc = join_merge_multi(bk, bv, pk, pv, M)
    k, bvs, pvs, valid = map(np.asarray, (k, bvs, pvs, valid))

    by_key = collections.defaultdict(list)
    for i in np.argsort(bk, kind="stable"):
        by_key[int(bk[i])].append(int(bv[i]))
    want, truncated_ref = [], False
    for i in range(np_):
        lst = by_key.get(int(pk[i]), [])
        truncated_ref |= len(lst) > M
        want.extend((int(pk[i]), v, int(pv[i])) for v in lst[:M])
    got = [
        (int(k[i]), int(bvs[j, i]), int(pvs[i]))
        for j in range(M)
        for i in np.nonzero(valid[j])[0]
    ]
    assert bool(trunc) == truncated_ref
    assert sorted(got) == sorted(want)


def test_join_merge_left(rng):
    from radx_tpu.ops.join import join_merge

    nb, npr = 3000, 5000
    bk = rng.permutation(20_000)[:nb].astype(np.uint32)
    bv = rng.integers(1, 2**32, nb, dtype=np.uint32)
    pk = rng.integers(0, 40_000, npr).astype(np.uint32)  # ~half unmatched
    pv = np.arange(npr, dtype=np.uint32)
    k, b, p, count = join_merge(
        bk, bv, pk, pv, how="left", missing=np.uint32(0)
    )
    count = int(count)
    assert count == npr  # LEFT JOIN: every probe row survives
    bmap = dict(zip(bk.tolist(), bv.tolist()))
    expect = sorted(
        (int(pk[i]), int(pv[i]), bmap.get(int(pk[i]), 0))
        for i in range(npr)
    )
    got = sorted(
        zip(
            np.asarray(k)[:count].tolist(),
            np.asarray(p)[:count].tolist(),
            np.asarray(b)[:count].tolist(),
        )
    )
    assert got == expect


def test_join_merge_left_missing_value_and_dup_builds(rng):
    from radx_tpu.ops.join import join_merge

    bk = np.array([7, 7, 9], np.uint32)
    bv = np.array([70, 71, 90], np.uint32)
    pk = np.array([7, 9, 8], np.uint32)
    pv = np.array([1, 2, 3], np.uint32)
    k, b, p, count = join_merge(
        bk, bv, pk, pv, how="left", missing=np.uint32(0xDEAD)
    )
    count = int(count)
    rows = sorted(
        zip(np.asarray(k)[:count].tolist(), np.asarray(p)[:count].tolist(),
            np.asarray(b)[:count].tolist())
    )
    assert rows == [(7, 1, 71), (8, 3, 0xDEAD), (9, 2, 90)]


@pytest.mark.parametrize("missing", [None, -1.25, np.nan])
def test_join_merge_left_float32_values(rng, missing):
    """float32 build values come back as themselves, and unmatched rows
    carry `missing` (default 0.0) — never an int32 bit plane promoted to
    float (the left join once returned 1.5 as 1.07e9)."""
    from radx_tpu.ops.join import join_merge

    bk = np.array([3, 5, 8], np.uint32)
    bv = np.array([1.5, -2.25, 3e-5], np.float32)
    pk = np.array([5, 4, 3, 8, 9], np.uint32)
    pv = np.arange(5, dtype=np.int32)
    k, b, p, count = join_merge(bk, bv, pk, pv, how="left", missing=missing)
    count = int(count)
    assert count == 5 and np.asarray(b).dtype == np.float32
    fill = np.float32(0.0 if missing is None else missing)
    want_b = np.array([1.5, fill, -2.25, 3e-5, fill], np.float32)
    np.testing.assert_array_equal(np.asarray(k)[:count], [3, 4, 5, 8, 9])
    np.testing.assert_array_equal(np.asarray(p)[:count], [2, 1, 0, 3, 4])
    np.testing.assert_array_equal(np.asarray(b)[:count], want_b)


def test_table_join_left(rng):
    from radx_tpu.ops.table import Table

    left = Table.from_arrays(
        k=np.array([1, 2, 3, 4], np.uint32),
        v=np.array([10, 20, 30, 40], np.uint32),
    )
    right = Table.from_arrays(
        k=np.array([2, 4], np.uint32),
        w=np.array([200, 400], np.uint32),
    )
    out = left.join(right, on="k", value="v", other_value="w",
                    how="left").to_numpy()
    rows = sorted(zip(out["k"].tolist(), out["v"].tolist(),
                      out["w"].tolist()))
    assert rows == [(1, 10, 0), (2, 20, 200), (3, 30, 0), (4, 40, 400)]
