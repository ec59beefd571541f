"""LazyTable: whole query pipelines under ONE jit, no per-operator host sync.

Covers VERDICT round-1 weak #9: eager `Table` operators call ``int(count)``
per step; `LazyTable` threads a traced count through validity-aware sort
planes and syncs exactly once in `collect()`.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from radx_tpu.ops.lazy import LazyTable
from radx_tpu.ops.table import Table



def _sales(rng, n=3000):
    return Table.from_arrays(
        store=rng.integers(0, 20, n).astype(np.uint32),
        amount=rng.integers(1, 500, n).astype(np.uint32),
        returned=(rng.random(n) < 0.1).astype(np.uint32),
    )


def test_filter_matches_eager(rng):
    t = _sales(rng)
    mask = np.asarray(t.column("returned")) == 0
    got = t.lazy().filter(mask).collect().to_numpy()
    want = t.filter(mask.astype(np.int32)).to_numpy()
    for name in ("store", "amount", "returned"):
        np.testing.assert_array_equal(got[name], want[name])


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
def test_groupby_matches_numpy(rng, agg):
    t = _sales(rng, n=2000)
    g = np.asarray(t.column("store"))
    v = np.asarray(t.column("amount"))
    got = t.lazy().groupby("store", "amount", agg).collect().to_numpy()
    uniq = np.unique(g)
    fn = {"sum": np.sum, "count": len, "min": np.min, "max": np.max}[agg]
    want = np.array([fn(v[g == u]) for u in uniq], dtype=np.uint32)
    np.testing.assert_array_equal(got["store"], uniq)
    np.testing.assert_array_equal(got[agg], want)


def test_filter_then_groupby_validity_threads(rng):
    """Rows dropped by filter must not contribute to the aggregate."""
    t = _sales(rng, n=1500)
    g = np.asarray(t.column("store"))
    v = np.asarray(t.column("amount"))
    r = np.asarray(t.column("returned"))
    lt = t.lazy()
    got = (
        lt.filter(lt.column("returned") == 0)
        .groupby("store", "amount", "sum")
        .collect()
        .to_numpy()
    )
    keep = r == 0
    uniq = np.unique(g[keep])
    want = np.array([v[keep & (g == u)].sum() for u in uniq], np.uint32)
    np.testing.assert_array_equal(got["store"], uniq)
    np.testing.assert_array_equal(got["sum"], want)


def test_join_matches_eager_single_match(rng):
    dims = Table.from_arrays(
        key=np.array([1, 2, 3, 5, 9, 12, 4, 8], np.uint32),
        weight=np.array([10, 20, 30, 50, 90, 120, 40, 80], np.uint32),
    )
    facts = Table.from_arrays(
        key=rng.integers(0, 14, 500).astype(np.uint32),
        amount=rng.integers(0, 1000, 500).astype(np.uint32),
    )
    got = (
        facts.lazy()
        .join(dims.lazy(), on="key", value="amount", other_value="weight")
        .collect()
        .to_numpy()
    )
    dk = {1: 10, 2: 20, 3: 30, 5: 50, 9: 90, 12: 120, 4: 40, 8: 80}
    fk = np.asarray(facts.column("key"))
    fa = np.asarray(facts.column("amount"))
    m = np.isin(fk, list(dk))
    want = sorted(zip(fk[m], fa[m], [dk[k] for k in fk[m]]))
    rows = sorted(zip(got["key"], got["amount"], got["weight"]))
    assert rows == want


def test_join_multi_matches_eager(rng):
    dims = Table.from_arrays(
        key=np.array([1, 1, 1, 2, 5, 5, 9, 12], np.uint32),
        weight=np.array([10, 11, 12, 20, 50, 51, 90, 120], np.uint32),
    )
    facts = Table.from_arrays(
        key=rng.integers(0, 14, 400).astype(np.uint32),
        amount=rng.integers(0, 1000, 400).astype(np.uint32),
    )
    lt, truncated = facts.lazy().join_multi(
        dims.lazy(), on="key", value="amount", other_value="weight",
        max_matches=4,
    )
    assert not bool(truncated)
    got = lt.collect().to_numpy()
    want_t = facts.join(
        dims, on="key", value="amount", other_value="weight",
        max_matches=4,
    ).to_numpy()
    got_rows = sorted(zip(got["key"], got["amount"], got["weight"]))
    want_rows = sorted(zip(want_t["key"], want_t["amount"], want_t["weight"]))
    assert got_rows == want_rows


def test_join_multi_truncation_flag(rng):
    dims = Table.from_arrays(
        key=np.full(5, 7, np.uint32),
        weight=np.arange(5, dtype=np.uint32),
    )
    facts = Table.from_arrays(
        key=np.array([7, 8], np.uint32),
        amount=np.array([1, 2], np.uint32),
    )
    lt, truncated = facts.lazy().join_multi(
        dims.lazy(), on="key", value="amount", other_value="weight",
        max_matches=2,
    )
    assert bool(truncated)  # 5 matches > max_matches=2
    got = lt.collect().to_numpy()
    # the kept rows are the first 2 build ranks of key 7
    assert sorted(got["weight"].tolist()) == [0, 1]


def test_join_multi_respects_validity(rng):
    # garbage rows past count must not join: filter first, then join_multi
    dims = Table.from_arrays(
        key=np.array([1, 1, 3], np.uint32),
        weight=np.array([10, 11, 30], np.uint32),
    )
    facts = Table.from_arrays(
        key=np.array([1, 3, 1, 3, 1], np.uint32),
        amount=np.array([100, 300, 101, 301, 102], np.uint32),
        keep=np.array([1, 1, 0, 0, 1], np.uint32),
    )
    lf = facts.lazy()
    kept = lf.filter(np.array([1, 1, 0, 0, 1], bool))
    lt, truncated = kept.join_multi(
        dims.lazy(), on="key", value="amount", other_value="weight",
        max_matches=3,
    )
    assert not bool(truncated)
    got = lt.collect().to_numpy()
    rows = sorted(zip(got["key"], got["amount"], got["weight"]))
    want = sorted(
        [(1, 100, 10), (1, 100, 11), (1, 102, 10), (1, 102, 11),
         (3, 300, 30)]
    )
    assert rows == want


def test_sort_by_descending(rng):
    t = _sales(rng, n=1000)
    got = t.lazy().sort_by("amount", descending=True).collect().to_numpy()
    order = np.argsort(-np.asarray(t.column("amount")).astype(np.int64),
                       kind="stable")
    for name in ("store", "amount"):
        np.testing.assert_array_equal(
            got[name], np.asarray(t.column(name))[order])


def test_whole_pipeline_one_jit(rng):
    """The headline: filter → groupby → sort fused into ONE XLA program."""
    t = _sales(rng, n=2048)

    @jax.jit
    def query(lt: LazyTable) -> LazyTable:
        kept = lt.filter(lt.column("returned") == 0)
        agg = kept.groupby("store", "amount", "sum")
        return agg.sort_by("sum", descending=True)

    out = query(t.lazy()).collect().to_numpy()

    g = np.asarray(t.column("store"))
    v = np.asarray(t.column("amount"))
    r = np.asarray(t.column("returned"))
    keep = r == 0
    want = sorted(
        ((int(v[keep & (g == u)].sum()), int(u)) for u in np.unique(g[keep])),
        reverse=True,
    )
    got = list(zip((int(x) for x in out["sum"]),
                   (int(x) for x in out["store"])))
    # stable sort on sum only: compare multisets of (sum, store) and the
    # sum ordering itself
    assert sorted(got, reverse=True) == want
    assert list(out["sum"]) == sorted(out["sum"], reverse=True)


def test_lazytable_is_pytree(rng):
    t = _sales(rng, n=512)
    lt = t.lazy()
    leaves, treedef = jax.tree_util.tree_flatten(lt)
    assert len(leaves) == 4  # 3 columns + count
    lt2 = jax.tree_util.tree_unflatten(treedef, leaves)
    assert lt2.columns.keys() == lt.columns.keys()
    assert int(lt2.count) == t.num_rows


def test_empty_filter_result(rng):
    t = _sales(rng, n=256)
    lt = t.lazy().filter(jnp.zeros((256,), jnp.int32))
    agg = lt.groupby("store", "amount", "sum")
    out = agg.collect()
    assert out.num_rows == 0


def test_all_max_key_groupby(rng):
    """Key 0xFFFFFFFF must not collide with the invalid-row ordering."""
    n = 64
    t = Table.from_arrays(
        k=np.full(n, 0xFFFFFFFF, np.uint32),
        v=np.arange(n, dtype=np.uint32),
    )
    lt = t.lazy().filter(np.arange(n) < 40)
    out = lt.groupby("k", "v", "sum").collect().to_numpy()
    np.testing.assert_array_equal(out["k"], [0xFFFFFFFF])
    np.testing.assert_array_equal(out["sum"], [np.arange(40).sum()])


@pytest.mark.parametrize("agg", ["sum", "count", "min", "max"])
def test_groupby_dense_matches_lazy_sort_path(rng, agg):
    """bins= routes through groupby_lazy_dense; results (incl. the min/max
    order-isomorphic DECODE and the n_valid gate after a filter) must match
    the sort-based lazy path exactly (ADVICE r2 medium)."""
    t = _sales(rng, n=2000)
    lt = t.lazy().filter(t.lazy().column("returned") == 0)
    got = lt.groupby("store", "amount", agg, bins=128).collect().to_numpy()
    want = lt.groupby("store", "amount", agg).collect().to_numpy()
    np.testing.assert_array_equal(got["store"], want["store"])
    np.testing.assert_array_equal(got[agg], want[agg])
    assert got[agg].dtype == want[agg].dtype


@pytest.mark.parametrize("agg", ["min", "max"])
def test_groupby_dense_float32_decodes(rng, agg):
    """float32 extrema through the dense path must come back as the actual
    float values, not encoded bit patterns."""
    n = 1024
    keys = rng.integers(0, 16, n).astype(np.uint32)
    vals = (rng.standard_normal(n) * 100).astype(np.float32)
    t = Table.from_arrays(store=keys, amount=vals)
    got = (
        t.lazy().groupby("store", "amount", agg, bins=128)
        .collect().to_numpy()
    )
    uniq = np.unique(keys)
    fn = np.min if agg == "min" else np.max
    want = np.array([fn(vals[keys == u]) for u in uniq], np.float32)
    np.testing.assert_array_equal(got["store"], uniq)
    np.testing.assert_array_equal(got[agg], want)


def test_lazy_distinct_matches_eager(rng):
    t = _sales(rng, n=2000)
    got = t.lazy().distinct("store").collect().to_numpy()
    want = t.distinct("store").to_numpy()
    for name in ("store", "amount", "returned"):
        np.testing.assert_array_equal(got[name], want[name])


def test_lazy_distinct_after_filter(rng):
    # distinct must see only valid rows: filter first, then dedupe
    t = _sales(rng, n=2000)
    mask = np.asarray(t.column("returned")) == 0
    got = (
        t.lazy().filter(mask).distinct("store").collect().to_numpy()
    )
    want = t.filter(mask.astype(np.int32)).distinct(
        "store"
    ).to_numpy()
    for name in ("store", "amount", "returned"):
        np.testing.assert_array_equal(got[name], want[name])


def test_lazy_topk_matches_eager(rng):
    t = _sales(rng, n=2048)
    got = t.lazy().top_k("amount", 50).collect().to_numpy()
    want = t.top_k("amount", 50).to_numpy()
    for name in ("store", "amount", "returned"):
        np.testing.assert_array_equal(got[name], want[name])


def test_lazy_topk_k_exceeds_count(rng):
    # after a filter leaves fewer than k valid rows, count clamps to them
    t = _sales(rng, n=2000)
    amounts = np.asarray(t.column("amount"))
    mask = amounts > 490  # few survivors
    lt = t.lazy().filter(mask).top_k("amount", 100)
    out = lt.collect().to_numpy()
    survivors = np.sort(amounts[mask])[::-1]
    kept = survivors[: min(100, survivors.size)]
    np.testing.assert_array_equal(out["amount"], kept.astype(np.uint32))
