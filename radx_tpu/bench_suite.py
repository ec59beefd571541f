"""Benchmark suite CLI — the analogue of the reference's test/benchmark app
(rad::TestSort, src/test/sort.cpp:246-483), with structured metrics instead
of raw prints and a correctness gate on every timed artifact (the reference
times but never checks, SURVEY §4).

Usage (on the GPU; it refuses to run elsewhere):
  python -m radx_tpu.bench_suite [--configs sort_8m,groupby_4m,...]
Prints one metrics row per config and a JSON summary line at the end.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def require_gpu():
    """The device metrics mean nothing off the card: exit with a message
    when JAX finds no GPU.  Returns the devices."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"{sys.argv[0]}: no GPU — JAX found {devs[0].platform!r} "
                 "devices; benchmarks run only on the card")
    return devs


def device_info():
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices())}


def _sort_bench(n, name):
    import jax.numpy as jnp

    from radx_tpu import runtime
    from radx_tpu.ops.sort import sort
    from radx_tpu.utils import time_op

    keys = runtime.gen_permutation(n, seed=1)  # the reference's fixture
    kj = jnp.asarray(keys)
    m = time_op(sort, kj, name=name, items=n, bytes_moved=8 * n)
    assert runtime.validate_sort(keys, np.asarray(sort(kj))) == 0, \
        "sort output invalid!"
    return m


def _pairs_bench(n, name, unique=False):
    import jax.numpy as jnp

    from radx_tpu import runtime
    from radx_tpu.ops.sort import sort_pairs
    from radx_tpu.utils import time_op

    keys = (runtime.gen_permutation(n, seed=12) if unique
            else runtime.gen_uniform(n, seed=2))
    vals = np.arange(n, dtype=np.int32)
    kv = (jnp.asarray(keys), jnp.asarray(vals))
    m = time_op(lambda kv: sort_pairs(*kv), kv, name=name, items=n,
                bytes_moved=16 * n)
    k_out, v_out = (np.asarray(x) for x in sort_pairs(*kv))
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(k_out, keys[order]), "pairs keys not sorted!"
    assert np.array_equal(v_out, order.astype(np.int32)), "pairs not stable!"
    return m


def _groupby_bench(n, name):
    import jax.numpy as jnp

    from radx_tpu import runtime
    from radx_tpu.ops.groupby import groupby
    from radx_tpu.utils import time_op

    keys = (runtime.gen_uniform(n, seed=3) % 10007).astype(np.uint32)
    vals = runtime.gen_uniform(n, seed=4)
    kv = (jnp.asarray(keys), jnp.asarray(vals))
    m = time_op(lambda kv: groupby(*kv, "sum"), kv, name=name, items=n,
                bytes_moved=16 * n)
    uk, agg, ng = groupby(*kv, "sum")
    ng = int(ng)
    want_k = np.unique(keys)
    assert np.array_equal(np.asarray(uk)[:ng], want_k), "groupby keys wrong!"
    want = np.zeros(want_k.shape, np.uint64)
    np.add.at(want, np.searchsorted(want_k, keys), vals.astype(np.uint64))
    assert np.array_equal(np.asarray(agg)[:ng], want.astype(np.uint32)), \
        "groupby sums wrong!"
    return m


def _groupby_dense_bench(n, name, agg, bins=1024):
    import jax.numpy as jnp

    from radx_tpu import runtime
    from radx_tpu.ops.groupby import groupby_dense
    from radx_tpu.utils import time_op

    keys = (runtime.gen_uniform(n, seed=6) % (bins - 7)).astype(np.uint32)
    vals = runtime.gen_uniform(n, seed=7)
    kv = (jnp.asarray(keys), jnp.asarray(vals))
    m = time_op(lambda kv: groupby_dense(*kv, agg, bins), kv, name=name,
                items=n, bytes_moved=8 * n)
    uk, out, ng = groupby_dense(*kv, agg, bins)
    ng = int(ng)
    want_k = np.unique(keys)
    assert np.array_equal(np.asarray(uk)[:ng], want_k), "dense keys wrong!"
    if agg == "sum":
        want = np.zeros(bins, np.uint64)
        np.add.at(want, keys, vals.astype(np.uint64))
        want = want.astype(np.uint32)
    else:
        want = np.full(bins, 0xFFFFFFFF, np.uint32)
        np.minimum.at(want, keys, vals)
    assert np.array_equal(np.asarray(out)[:ng], want[want_k]), \
        f"dense {agg} wrong!"
    return m


def _filter_bench(n, name):
    import jax.numpy as jnp

    from radx_tpu import runtime
    from radx_tpu.ops.filter import filter_columns
    from radx_tpu.utils import time_op

    vals = runtime.gen_uniform(n, seed=5)
    vj = jnp.asarray(vals)
    m = time_op(lambda v: filter_columns(v & 1, [v]), vj, name=name, items=n,
                bytes_moved=12 * n)
    (out,), cnt = filter_columns(vj & 1, [vj])
    cnt = int(cnt)
    assert np.array_equal(np.asarray(out)[:cnt], vals[(vals & 1) != 0]), \
        "filter output wrong!"
    return m


def _topk_bench(n, name, k=1024):
    import jax.numpy as jnp

    from radx_tpu import runtime
    from radx_tpu.ops.topk import top_k
    from radx_tpu.utils import time_op

    keys = runtime.gen_uniform(n, seed=11)
    x = jnp.asarray(keys)
    m = time_op(lambda v: top_k(v, k), x, name=name, items=n,
                bytes_moved=8 * n)
    vals, idx = top_k(x, k)
    order = np.argsort(~keys.astype(np.uint64), kind="stable")[:k]
    assert np.array_equal(np.asarray(idx), order.astype(np.int32)), \
        "top_k indices wrong!"
    assert np.array_equal(np.asarray(vals), keys[order]), "top_k values wrong!"
    return m


CONFIGS = {
    "sort_8m": lambda: _sort_bench(1 << 23, "sort_u32 2^23"),
    "sort_64m": lambda: _sort_bench(1 << 26, "sort_u32 2^26"),
    "sort_268m": lambda: _sort_bench(1 << 28, "sort_u32 2^28"),
    "pairs_4m": lambda: _pairs_bench(1 << 22, "sort_pairs 2^22"),
    "pairs_256m": lambda: _pairs_bench(1 << 28, "sort_pairs 2^28"),
    "pairs_unique_4m": lambda: _pairs_bench(
        1 << 22, "sort_pairs_unique 2^22", unique=True
    ),
    "pairs_unique_256m": lambda: _pairs_bench(
        1 << 28, "sort_pairs_unique 2^28", unique=True
    ),
    "groupby_4m": lambda: _groupby_bench(1 << 22, "groupby_sum 2^22"),
    "groupby_64m": lambda: _groupby_bench(1 << 26, "groupby_sum 2^26"),
    "groupby_dense_16m": lambda: _groupby_dense_bench(
        1 << 24, "groupby_dense 2^24 bins=1024", "sum"
    ),
    "groupby_minmax_16m": lambda: _groupby_dense_bench(
        1 << 24, "groupby_dense_min 2^24 bins=1024", "min"
    ),
    "filter_64m": lambda: _filter_bench(1 << 26, "filter 2^26"),
    "topk_64m": lambda: _topk_bench(1 << 26, "top_k 2^26 k=1024"),
}


def run_configs(names):
    """Run the named configs in this process; returns their result rows."""
    rows = []
    for name in names:
        m = CONFIGS[name]()
        print(m.row(), file=sys.stderr, flush=True)
        rows.append({"config": name, "seconds": m.seconds,
                     "items_per_s": m.items_per_s,
                     "spread_pct": m.spread_pct})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", default="sort_8m")
    args = ap.parse_args(argv)
    names = [c.strip() for c in args.configs.split(",")]
    unknown = [c for c in names if c not in CONFIGS]
    if unknown:
        print(f"unknown configs {unknown}; have {sorted(CONFIGS)}")
        return 2
    require_gpu()
    print(json.dumps({**device_info(), "suite": run_configs(names)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
