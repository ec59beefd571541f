"""int32/float32 keys through the query surface (VERDICT r4 #7).

The engine's order-preserving encodings (ops/core.encode_keys) were only
reachable via sort_any/sort_pairs_any through round 4; these tests pin the
round-5 threading through groupby / join / Table / LazyTable.  Reference
parity note: RadX is uint32-only (SURVEY §2) — dtype coverage is part of
the query-executor surface BASELINE.json demands.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from radx_tpu.ops import groupby as groupby_ops
from radx_tpu.ops import join as join_ops
from radx_tpu.ops.table import Table



def _f32_keys(rng, n):
    # negatives, positives, zeros, repeats — exercises the sign-magnitude
    # encoding and duplicate grouping
    base = np.asarray([-3.5, -1.25, -0.0, 0.0, 2.0, 7.75], np.float32)
    return base[rng.integers(0, len(base), n)]


def _i32_keys(rng, n):
    base = np.asarray([-2**31, -177, -1, 0, 5, 2**31 - 1], np.int32)
    return base[rng.integers(0, len(base), n)]


@pytest.mark.parametrize("maker", [_f32_keys, _i32_keys])
def test_groupby_typed_keys_sum(rng, maker):
    n = 4 * 128
    keys = maker(rng, n)
    vals = rng.integers(0, 1000, n).astype(np.uint32)
    uk, agg, ng = groupby_ops.groupby(keys, vals, "sum")
    ng = int(ng)
    uk = np.asarray(jax.device_get(uk))[:ng]
    agg = np.asarray(jax.device_get(agg))[:ng]
    # NOTE -0.0/+0.0: the engine groups by BIT PATTERN (distinct groups);
    # np.unique merges them, so compare in the encoded domain
    from radx_tpu.ops.core import encode_keys as _encode_keys

    enc = np.asarray(jax.device_get(_encode_keys(jnp.asarray(keys))))
    want_enc = np.unique(enc)
    got_enc = np.asarray(jax.device_get(_encode_keys(jnp.asarray(uk))))
    np.testing.assert_array_equal(got_enc, want_enc)
    want_sums = np.zeros(want_enc.shape, np.uint64)
    np.add.at(want_sums, np.searchsorted(want_enc, enc),
              vals.astype(np.uint64))
    np.testing.assert_array_equal(agg, want_sums.astype(np.uint32))


def test_groupby_f32_min_value_and_key(rng):
    n = 4 * 128
    keys = _f32_keys(rng, n)
    vals = rng.standard_normal(n).astype(np.float32)
    uk, agg, ng = groupby_ops.groupby(keys, vals, "min")
    ng = int(ng)
    uk = np.asarray(jax.device_get(uk))[:ng]
    agg = np.asarray(jax.device_get(agg))[:ng]
    keybits = keys.view(np.uint32)
    want_k = []
    want_min = []
    from radx_tpu.ops.core import encode_keys as _encode_keys

    enc = np.asarray(jax.device_get(_encode_keys(jnp.asarray(keys))))
    for e in np.unique(enc):
        sel = enc == e
        want_k.append(keys[sel][0])
        want_min.append(vals[sel].min())
    np.testing.assert_array_equal(uk.view(np.uint32),
                                  np.asarray(want_k, np.float32).view(np.uint32))
    np.testing.assert_array_equal(agg, np.asarray(want_min, np.float32))


def test_groupby_dense_int32_keys(rng):
    n = 4 * 128
    keys = rng.integers(0, 100, n).astype(np.int32)
    vals = rng.integers(0, 1000, n).astype(np.uint32)
    uk, agg, ng = groupby_ops.groupby_dense(keys, vals, "sum", 128)
    ng = int(ng)
    uk = np.asarray(jax.device_get(uk))[:ng]
    agg = np.asarray(jax.device_get(agg))[:ng]
    assert uk.dtype == np.int32
    want_k = np.unique(keys)
    np.testing.assert_array_equal(uk, want_k)
    want = np.zeros(128, np.uint64)
    np.add.at(want, keys, vals.astype(np.uint64))
    np.testing.assert_array_equal(agg, want.astype(np.uint32)[want_k])


def test_groupby_dense_negative_int32_key_raises(rng):
    keys = np.asarray([-1, 0, 1, 2] * 32, np.int32)
    vals = np.ones(128, np.uint32)
    with pytest.raises(ValueError, match="key < bins"):
        groupby_ops.groupby_dense(keys, vals, "sum", 128)


@pytest.mark.parametrize("maker", [_f32_keys, _i32_keys])
def test_join_merge_typed_keys(rng, maker):
    nb, npr = 2 * 128, 2 * 128
    pool = maker(rng, 16)
    build_keys = pool[rng.integers(0, 16, nb)]
    probe_keys = pool[rng.integers(0, 16, npr)]
    build_vals = np.arange(nb, dtype=np.uint32)
    probe_vals = np.arange(npr, dtype=np.uint32) + 1000
    k, bv, pv, count = join_ops.join_merge(
        build_keys, build_vals, probe_keys, probe_vals
    )
    count = int(count)
    k = np.asarray(jax.device_get(k))[:count]
    bv = np.asarray(jax.device_get(bv))[:count]
    pv = np.asarray(jax.device_get(pv))[:count]
    assert k.dtype == build_keys.dtype
    # oracle: last build row per key wins, bit-pattern key identity
    bbits = build_keys.view(np.uint32)
    pbits = probe_keys.view(np.uint32)
    last = {}
    for i in range(nb):
        last[bbits[i]] = build_vals[i]
    want = sorted(
        (pbits[j], probe_vals[j], last[pbits[j]])
        for j in range(npr)
        if pbits[j] in last
    )
    got = sorted(zip(k.view(np.uint32), pv, bv))
    # per-row multisets must match (key order may differ inside ties)
    assert sorted(got) == sorted(
        [(int(a), int(b), int(c)) for a, b, c in want]
    )


def test_table_query_f32_keys(rng):
    n = 4 * 128
    keys = _f32_keys(rng, n)
    vals = rng.integers(0, 100, n).astype(np.uint32)
    t = Table.from_arrays(k=keys, v=vals)
    g = t.groupby("k", "v", "sum")
    assert g.column("k").dtype == jnp.float32
    # sort_by on the f32 key column
    s = t.sort_by("k")
    out = np.asarray(jax.device_get(s.column("k")))
    assert np.all(out[:-1] <= out[1:])


def test_lazy_pipeline_f32_keys(rng):
    n = 4 * 128
    keys = _f32_keys(rng, n)
    vals = rng.integers(1, 100, n).astype(np.uint32)
    t = Table.from_arrays(k=keys, v=vals).lazy()
    g = t.filter(t.column("v") > 10).groupby("k", "v", "sum").collect()
    got_k = np.asarray(jax.device_get(g.column("k")))
    got_s = np.asarray(jax.device_get(g.column("sum")))
    assert got_k.dtype == np.float32
    sel = vals > 10
    from radx_tpu.ops.core import encode_keys as _encode_keys

    enc = np.asarray(jax.device_get(_encode_keys(jnp.asarray(keys))))[sel]
    want_enc = np.unique(enc)
    want = np.zeros(want_enc.shape, np.uint64)
    np.add.at(want, np.searchsorted(want_enc, enc),
              vals[sel].astype(np.uint64))
    got_enc = np.asarray(jax.device_get(_encode_keys(jnp.asarray(got_k))))
    np.testing.assert_array_equal(got_enc, want_enc)
    np.testing.assert_array_equal(got_s, want.astype(np.uint32))


def test_lazy_join_i32_keys(rng):
    nb = npr = 2 * 128
    build_keys = _i32_keys(rng, nb)
    probe_keys = _i32_keys(rng, npr)
    bt = Table.from_arrays(
        k=build_keys, bv=np.arange(nb, dtype=np.uint32)
    ).lazy()
    pt = Table.from_arrays(
        k=probe_keys, pv=np.arange(npr, dtype=np.uint32)
    ).lazy()
    j = pt.join(bt, on="k", value="pv", other_value="bv").collect()
    k = np.asarray(jax.device_get(j.column("k")))
    assert k.dtype == np.int32
    # row count parity with the eager typed join
    _, _, _, count = join_ops.join_merge(
        build_keys, np.arange(nb, dtype=np.uint32),
        probe_keys, np.arange(npr, dtype=np.uint32),
    )
    assert j.num_rows == int(count)
