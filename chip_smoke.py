"""Smoke run of the query engine on the GPU, at the BASELINE's sizes.

    python chip_smoke.py              # one card: every single-device phase
    python chip_smoke.py --chips 4    # four cards: the sharded sort only

Each phase drives a public entry point (radx_tpu.sort, argsort, sort_pairs,
sort_any, sort_u64, filter_columns, groupby, groupby_dense, join_merge,
join_merge_multi, top_k, unique, a LazyTable pipeline, parallel.dist_sort)
at the size the BASELINE names — 2^28 keys ("256M"), 10^8 x 10^8 join rows
("100M"), 2^28 keys per card for the sharded sort — on inputs from the
seeded generators of radx_tpu.runtime, and compares the result with an
independent reference: the C++ oracle (cpp/oracle.cc) for sorts, NumPy
otherwise.  Integer results must match bit for bit; float32 group sums
within the worst-case bound of float32 summation in any order.

Per phase it prints one JSON line: phase, n, ok, compile and run seconds
(first and second call), and the device's peak_bytes_in_use so far.  It
prints the card's name and power limit first, and as its last line
{"ok": true, "device": {...}}.  Any failed phase raises: the script exits
non-zero and prints no result.  It refuses to run without a GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time

import numpy as np

FULL = {  # phase -> BASELINE size
    "sort": 1 << 28,
    "argsort_pairs": 1 << 28,
    "sort_any": 1 << 26,
    "filter": 1 << 28,
    "groupby": 1 << 28,
    "groupby_dense": 1 << 28,
    "join": 10**8,
    "topk_unique": 1 << 28,
    "lazy_pipeline": 1 << 28,
    "cub_hlo": 1 << 20,
}
DIST_PER_CARD = 1 << 28


def card_line() -> str:
    """nvidia-smi's name and power limit, read by a child that does not
    import JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    return out


# --- references ---------------------------------------------------------


def _np(x):
    import jax

    return np.asarray(jax.device_get(x))


def _same(got, want, what):
    got = np.asarray(got)
    want = np.asarray(want)
    if got.shape != want.shape or not np.array_equal(
        got.view(np.uint32) if got.dtype.itemsize == 4 else got,
        want.view(np.uint32) if want.dtype.itemsize == 4 else want,
    ):
        bad = "shape" if got.shape != want.shape else int(
            np.flatnonzero(got != want)[0]
        )
        raise AssertionError(f"{what}: mismatch (first at {bad})")


def _stable_order(keys):
    """Stable argsort of uint32 keys by the C++ oracle's LSD pair sort."""
    from radx_tpu.oracle import native

    sk, perm = native.sort_pairs(keys, np.arange(keys.size, dtype=np.uint32))
    return sk, perm.astype(np.int64)


def _sum_u32(keys, vals, bins):
    """Exact per-key uint32 sums mod 2^32 via two 16-bit float64 bincounts."""
    lo = np.bincount(keys, weights=vals & 0xFFFF, minlength=bins)
    hi = np.bincount(keys, weights=vals >> 16, minlength=bins)
    return (lo.astype(np.uint64) + (hi.astype(np.uint64) << np.uint64(16))
            ).astype(np.uint32)


def _runs(keys, vals):
    """Runs of equal keys after a stable sort of (keys, vals): (sorted
    keys, sorted values, run starts, run lengths)."""
    sk, perm = _stable_order(keys)
    starts = np.flatnonzero(np.concatenate([[True], sk[1:] != sk[:-1]]))
    return sk, vals[perm], starts, np.diff(np.append(starts, sk.size))


def _group_ref(runs, agg):
    """Per-key aggregate over the runs of _runs (uint32 or float32
    values; float32 sums in float64).  Returns (unique keys, aggregate)."""
    sk, sv, starts, counts = runs
    if agg == "count":
        out = counts.astype(np.int32)
    elif agg == "sum" and sv.dtype == np.float32:
        out = np.add.reduceat(sv.astype(np.float64), starts)
    elif agg == "sum":
        out = np.add.reduceat(sv.astype(np.uint64), starts).astype(np.uint32)
    else:
        fold = np.minimum if agg == "min" else np.maximum
        out = fold.reduceat(sv, starts)
    return sk[starts], out


# --- phases: each returns (op, check); op() runs on the device ------------


def phase_sort(n, seed):
    import jax.numpy as jnp
    import radx_tpu as rx
    from radx_tpu import runtime
    from radx_tpu.oracle import native

    uni = runtime.gen_uniform(n, seed)
    perm = runtime.gen_permutation(n, seed + 1)  # the reference's fixture
    du, dp = jnp.asarray(uni), jnp.asarray(perm)

    def op():
        return rx.sort(du), rx.sort(dp)

    def check(out):
        _same(_np(out[0]), native.sort_u32(uni), "sort uniform")
        _same(_np(out[1]), np.arange(n, dtype=np.uint32), "sort permutation")

    return op, check


def phase_argsort_pairs(n, seed):
    import jax.numpy as jnp
    import radx_tpu as rx
    from radx_tpu import runtime

    keys = runtime.gen_uniform(n, seed) % np.uint32(4096)  # heavy duplicates
    vals = runtime.gen_uniform(n, seed + 1)
    dk, dv = jnp.asarray(keys), jnp.asarray(vals)

    def op():
        return rx.argsort(dk), rx.sort_pairs(dk, dv)

    def check(out):
        sk, perm = _stable_order(keys)
        _same(_np(out[0]), perm.astype(np.int32), "argsort")
        _same(_np(out[1][0]), sk, "sort_pairs keys")
        _same(_np(out[1][1]), vals[perm], "sort_pairs payload")

    return op, check


def _float_ref_sort(x):
    """np.sort in the engine's documented float total order:
    -inf < ... < -0.0 < +0.0 < ... < +inf < nan (np.sort leaves the order
    of -0.0 and +0.0 open; put the negative zeros first)."""
    s = np.sort(x)
    z = np.flatnonzero(s == 0)
    if z.size:
        neg = int(np.count_nonzero(np.signbit(x) & (x == 0)))
        s[z[0]: z[0] + neg] = -0.0
        s[z[0] + neg: z[-1] + 1] = 0.0
    return s


def phase_sort_any(n, seed):
    import jax.numpy as jnp
    import radx_tpu as rx
    from radx_tpu import runtime

    bits = runtime.gen_uniform(n, seed)
    i32 = bits.view(np.int32)
    f32 = (i32 >> 7).astype(np.float32) * np.float32(2.0 ** -20)
    f32[:: 997] = np.float32(-0.0)
    f32[1:: 1009] = np.float32(0.0)
    f32[2:: 4099] = np.inf
    f32[3:: 4111] = -np.inf
    f32[4:: 8191] = np.nan
    u64 = (runtime.gen_uniform(n, seed + 1).astype(np.uint64) << np.uint64(32)
           ) | (bits % np.uint32(64)).astype(np.uint64)  # ties in the high half
    hi = (u64 >> np.uint64(32)).astype(np.uint32)
    lo = (u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    di, df = jnp.asarray(i32), jnp.asarray(f32)
    dh, dl = jnp.asarray(hi), jnp.asarray(lo)

    def op():
        return (rx.sort_any(di), rx.sort_any(di, descending=True),
                rx.sort_any(df), rx.sort_any(df, descending=True),
                rx.sort_u64(dh, dl))

    def check(out):
        si = np.sort(i32)
        sf = _float_ref_sort(f32)
        _same(_np(out[0]), si, "int32 ascending")
        _same(_np(out[1]), si[::-1], "int32 descending")
        _same(_np(out[2]), sf, "float32 ascending")
        _same(_np(out[3]), sf[::-1], "float32 descending")
        s64 = np.sort(u64)
        _same(_np(out[4][0]), (s64 >> np.uint64(32)).astype(np.uint32),
              "sort_u64 hi")
        _same(_np(out[4][1]), (s64 & np.uint64(0xFFFFFFFF)).astype(
            np.uint32), "sort_u64 lo")

    return op, check


def phase_filter(n, seed):
    import jax.numpy as jnp
    import radx_tpu as rx
    from radx_tpu import runtime

    r = runtime.gen_uniform(n, seed)
    a = runtime.gen_uniform(n, seed + 1)
    b = (a >> 8).astype(np.float32)
    masks = {"50%": (r & 1) == 0, "3%": r % np.uint32(100) < 3}
    dm = {k: jnp.asarray(m) for k, m in masks.items()}
    da, db = jnp.asarray(a), jnp.asarray(b)

    def op():
        return {k: rx.filter_columns(m, [da, db]) for k, m in dm.items()}

    def check(out):
        for k, m in masks.items():
            (ga, gb), cnt = out[k]
            cnt = int(cnt)
            if cnt != int(m.sum()):
                raise AssertionError(f"filter {k}: count {cnt}")
            _same(_np(ga[:cnt]), a[m], f"filter {k} uint32")
            _same(_np(gb[:cnt]), b[m], f"filter {k} float32")

    return op, check


def _check_groups(got, uk, want, what, float_runs=None):
    gk, gv, ng = got
    ng = int(ng)
    if ng != uk.size:
        raise AssertionError(f"{what}: {ng} groups, want {uk.size}")
    _same(_np(gk[:ng]), uk, f"{what} keys")
    gv = _np(gv[:ng])
    if float_runs is None:
        _same(gv, want, f"{what} values")
        return
    # float32 summation of m terms in any order errs by at most
    # (m-1)·2^-24·Σ|v| per group
    _, sv, starts, counts = float_runs
    abs_sum = np.add.reduceat(np.abs(sv.astype(np.float64)), starts)
    bound = np.maximum(counts - 1, 1) * 2.0 ** -24 * abs_sum
    err = np.abs(gv.astype(np.float64) - want)
    if not np.all(err <= bound):
        i = int(np.flatnonzero(err > bound)[0])
        raise AssertionError(f"{what}: group {i} off by {err[i]} > {bound[i]}")


def phase_groupby(n, seed, n_keys=1 << 20):
    import jax.numpy as jnp
    import radx_tpu as rx
    from radx_tpu import runtime

    n_keys = min(n_keys, n)
    keys = runtime.gen_uniform(n, seed) % np.uint32(n_keys)
    vu = runtime.gen_uniform(n, seed + 1)
    vf = (vu.view(np.int32) >> 8).astype(np.float32) * np.float32(2.0 ** -16)
    dk, du, df = jnp.asarray(keys), jnp.asarray(vu), jnp.asarray(vf)
    aggs = ("sum", "count", "min", "max")

    def op():
        return {(a, t): rx.groupby(dk, v, a) for a in aggs
                for t, v in (("u32", du), ("f32", df))}

    def check(out):
        for t, vals in (("u32", vu), ("f32", vf)):
            runs = _runs(keys, vals)
            for a in aggs:
                uk, want = _group_ref(runs, a)
                _check_groups(
                    out[(a, t)], uk, want, f"groupby {a} {t}",
                    runs if (t == "f32" and a == "sum") else None,
                )

    return op, check


def phase_groupby_dense(n, seed):
    import jax.numpy as jnp
    import radx_tpu as rx
    from radx_tpu import runtime

    r = runtime.gen_uniform(n, seed)
    vals = runtime.gen_uniform(n, seed + 1)
    dv = jnp.asarray(vals)
    cases = {}
    for bins in (128, 65536):
        keys = r % np.uint32(bins)
        cases[bins] = (keys, jnp.asarray(keys))
    aggs = ("sum", "count", "min", "max")

    def op():
        return {(b, a): rx.groupby_dense(dk, dv, a, bins=b)
                for b, (_, dk) in cases.items() for a in aggs}

    def check(out):
        for b, (keys, _) in cases.items():
            counts = np.bincount(keys, minlength=b)
            uk = np.flatnonzero(counts).astype(np.uint32)
            runs = _runs(keys, vals)
            ref = {"sum": _sum_u32(keys, vals, b)[uk],
                   "count": counts[uk].astype(np.int32),
                   "min": _group_ref(runs, "min")[1],
                   "max": _group_ref(runs, "max")[1]}
            for a in aggs:
                _check_groups(out[(b, a)], uk, ref[a],
                              f"groupby_dense {a} bins={b}")

    return op, check


def phase_join(n, seed):
    import jax.numpy as jnp
    from radx_tpu import runtime
    from radx_tpu.ops import join as J

    nb = n_p = n
    bk = runtime.gen_permutation(nb, seed)  # unique build keys
    bv = (runtime.gen_uniform(nb, seed + 1) >> 8).astype(np.float32) + 0.5
    pk = runtime.gen_uniform(n_p, seed + 2) % np.uint32(2 * nb)  # ~50% hit
    pv = np.arange(n_p, dtype=np.uint32)
    bk2 = ((bk.astype(np.uint64) * 2) // 5).astype(np.uint32)  # 2-3 dups
    missing = np.float32(-1.25)
    M = 4
    d = {k: jnp.asarray(v) for k, v in
         dict(bk=bk, bv=bv, pk=pk, pv=pv, bk2=bk2).items()}

    def op():
        return (
            J.join_merge(d["bk"], d["bv"], d["pk"], d["pv"]),
            J.join_merge(d["bk"], d["bv"], d["pk"], d["pv"], how="left",
                         missing=missing),
            J.join_merge_multi(d["bk2"], d["bv"], d["pk"], d["pv"],
                               max_matches=M),
        )

    def check(out):
        spk, sprow = _stable_order(pk)  # probes in key order, ties in order
        sbk, sbrow = _stable_order(bk)
        last = np.searchsorted(sbk, spk, side="right") - 1
        hit = (last >= 0) & (sbk[np.maximum(last, 0)] == spk)
        brow = sbrow[np.maximum(last, 0)]
        for (k, b, p, c), how in ((out[0], "inner"), (out[1], "left")):
            sel = hit if how == "inner" else np.ones_like(hit)
            c = int(c)
            if c != int(sel.sum()):
                raise AssertionError(f"join {how}: count {c}")
            want_b = np.where(hit, bv[brow], missing)[sel]
            _same(_np(k[:c]), spk[sel], f"join {how} keys")
            _same(_np(b[:c]), want_b, f"join {how} build values")
            _same(_np(p[:c]), sprow[sel].astype(np.uint32),
                  f"join {how} probe values")
        k, bvs, pvs, valid, trunc = out[2]
        if bool(trunc):
            raise AssertionError("join_merge_multi truncated")
        sbk2, sbrow2 = _stable_order(bk2)
        lo = np.searchsorted(sbk2, spk, side="left")
        cnt = np.searchsorted(sbk2, spk, side="right") - lo
        rep = np.repeat(np.arange(n_p), cnt)
        rank = np.arange(rep.size) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        v = _np(valid).T.reshape(-1)
        if int(v.sum()) != rep.size:
            raise AssertionError("join_merge_multi: match count")
        _same(np.repeat(_np(k), M)[v], spk[rep], "join multi keys")
        _same(_np(bvs).T.reshape(-1)[v], bv[sbrow2[lo[rep] + rank]],
              "join multi build values")
        _same(np.repeat(_np(pvs), M)[v], sprow[rep].astype(np.uint32),
              "join multi probe values")

    return op, check


def _topk_ref(keys, k, largest):
    kk = keys.astype(np.int64)
    if largest:
        thr = np.partition(kk, kk.size - k)[kk.size - k]
        cand = np.flatnonzero(kk >= thr)
        order = cand[np.lexsort((cand, -kk[cand]))][:k]
    else:
        thr = np.partition(kk, k - 1)[k - 1]
        cand = np.flatnonzero(kk <= thr)
        order = cand[np.lexsort((cand, kk[cand]))][:k]
    return keys[order], order.astype(np.int32)


def phase_topk_unique(n, seed, k=1000):
    import jax.numpy as jnp
    import radx_tpu as rx
    from radx_tpu import runtime
    from radx_tpu.oracle import native

    k = min(k, n)
    keys = runtime.gen_uniform(n, seed) % np.uint32(1 << 20)  # ties
    ukeys = runtime.gen_uniform(n, seed + 1) % np.uint32(1 << 24)
    dk, du = jnp.asarray(keys), jnp.asarray(ukeys)

    def op():
        return (rx.top_k(dk, k, largest=True), rx.top_k(dk, k, largest=False),
                rx.unique(du, return_counts=True))

    def check(out):
        for (v, i), largest in ((out[0], True), (out[1], False)):
            wv, wi = _topk_ref(keys, k, largest)
            _same(_np(v), wv, f"top_k largest={largest} values")
            _same(_np(i), wi, f"top_k largest={largest} indices")
        s = native.sort_u32(ukeys)
        starts = np.flatnonzero(np.concatenate([[True], s[1:] != s[:-1]]))
        counts = np.diff(np.append(starts, s.size)).astype(np.int32)
        vals, cnts, c = out[2]
        c = int(c)
        if c != starts.size:
            raise AssertionError(f"unique: {c} values, want {starts.size}")
        _same(_np(vals[:c]), s[starts], "unique values")
        _same(_np(cnts[:c]), counts, "unique counts")

    return op, check


def phase_lazy_pipeline(n, seed, n_keys=1 << 20):
    import jax.numpy as jnp
    import radx_tpu as rx
    from radx_tpu import runtime

    n_keys = min(n_keys, n)
    key = runtime.gen_uniform(n, seed) % np.uint32(n_keys)
    val = runtime.gen_uniform(n, seed + 1)
    flag = runtime.gen_uniform(n, seed + 2) % np.uint32(4)
    t = rx.Table.from_arrays(key=key, val=val, flag=flag)

    def op():
        lt = t.lazy()
        return (lt.filter(lt.column("flag") != 0)
                .groupby("key", "val", "sum")
                .sort_by("sum", descending=True)
                .collect())

    def check(out):
        m = flag != 0
        counts = np.bincount(key[m], minlength=n_keys)
        uk = np.flatnonzero(counts).astype(np.uint32)
        sums = _sum_u32(key[m], val[m], n_keys)[uk]
        order = np.argsort(~sums, kind="stable")  # descending, stable
        got = out.to_numpy()
        _same(got["key"], uk[order], "pipeline keys")
        _same(got["sum"], sums[order], "pipeline sums")

    return op, check


def cub_sorts_in_hlo(n):
    """Whether XLA lowered each sort form to CUB's radix sort: the compiled
    HLO then calls the DeviceRadixSort custom call."""
    import jax
    import jax.numpy as jnp
    import radx_tpu as rx

    k = jnp.zeros((n,), jnp.uint32)
    v = jnp.zeros((n,), jnp.int32)
    forms = {
        "sort_u32": (lambda k, v: jax.lax.sort(k)),
        "argsort_stable": (lambda k, v: rx.argsort(k)),
        "sort_pairs": (lambda k, v: rx.sort_pairs(k, v)),
    }
    return {
        name: "DeviceRadixSort" in jax.jit(f).lower(k, v).compile().as_text()
        for name, f in forms.items()
    }


def phase_cub_hlo(n, seed):
    def op():
        return cub_sorts_in_hlo(n)

    def check(out):
        print(json.dumps({"cub_radix_sort": out}), flush=True)

    return op, check


PHASES = {
    "sort": phase_sort,
    "argsort_pairs": phase_argsort_pairs,
    "sort_any": phase_sort_any,
    "filter": phase_filter,
    "groupby": phase_groupby,
    "groupby_dense": phase_groupby_dense,
    "join": phase_join,
    "topk_unique": phase_topk_unique,
    "lazy_pipeline": phase_lazy_pipeline,
    "cub_hlo": phase_cub_hlo,
}


# --- the sharded sort on four cards ---------------------------------------


def phase_dist(n_per_dev, seed, n_dev=4):
    """sort_sharded (flat and hier), sort_pairs_sharded and
    sort_sharded_auto on a 1-D mesh of n_dev devices; each shard is put on
    its own device.  References come from the C++ oracle in a thread that
    runs while the devices sort."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radx_tpu import runtime
    from radx_tpu.oracle import native
    from radx_tpu.parallel import dist_sort, make_mesh

    n = n_per_dev * n_dev
    mesh = make_mesh(n_dev)
    shard = NamedSharding(mesh, P("d"))
    keys = runtime.gen_uniform(n, seed)
    vals = runtime.gen_uniform(n, seed + 1)
    skew = runtime.gen_skewed(n, seed + 2)
    pool = ThreadPoolExecutor(2)
    ref_pairs = pool.submit(
        native.sort_pairs, keys, np.arange(n, dtype=np.uint32)
    )
    ref_skew = pool.submit(native.sort_u32, skew)
    dk, dv, ds = (jax.device_put(x, shard) for x in (keys, vals, skew))

    def op():
        return (
            dist_sort.sort_sharded(dk, mesh, capacity=2),
            dist_sort.sort_sharded(dk, mesh, capacity=2, exchange="hier"),
            dist_sort.sort_pairs_sharded(dk, dv, mesh, capacity=2),
            dist_sort.sort_sharded_auto(ds, mesh),
        )

    def check(out):
        for i, o in enumerate(out[:3]):
            if _np(o[-1]).any():
                raise AssertionError(f"dist phase {i}: slot overflow")
        sk, perm = ref_pairs.result()
        for o, what in ((out[0], "flat"), (out[1], "hier")):
            _same(dist_sort.collect(o[0], o[1]), sk, f"sort_sharded {what}")
        k, v, valid, _ = out[2]
        _same(dist_sort.collect(k, valid), sk, "sort_pairs_sharded keys")
        _same(dist_sort.collect(v, valid), vals[perm],
              "sort_pairs_sharded values")
        ak, avalid, cap = out[3]
        _same(dist_sort.collect(ak, avalid), ref_skew.result(),
              f"sort_sharded_auto skewed (capacity {cap})")
        pool.shutdown()

    return op, check


# --- runner ---------------------------------------------------------------


def _peak(devices):
    """The largest peak_bytes_in_use over `devices` (None where the backend
    keeps no statistics, as the CPU's does not)."""
    stats = [d.memory_stats() for d in devices]
    if any(s is None for s in stats):
        return None
    return max(s["peak_bytes_in_use"] for s in stats)


def run_phase(name, make, n, seed, devices):
    """Build the phase, time two calls of its op (the first compiles),
    check the second call's result, and print one JSON line.  A failure
    raises."""
    import jax

    op, check = make(n, seed)
    t0 = time.perf_counter()
    jax.block_until_ready(op())
    t1 = time.perf_counter()
    out = jax.block_until_ready(op())
    t2 = time.perf_counter()
    check(out)
    del out
    row = {
        "phase": name, "n": n, "ok": True,
        "compile_s": round((t1 - t0) - (t2 - t1), 3),
        "run_s": round(t2 - t1, 3),
        "peak_bytes_in_use": _peak(devices),
    }
    print(json.dumps(row), flush=True)
    return row


def run(phases, seed, shift=0, n_dev=1):
    """Run `phases` (names of PHASES, or "dist") at their BASELINE sizes
    divided by 2^shift."""
    import jax

    devices = jax.devices()[:n_dev]
    for name in phases:
        if name == "dist":
            make = functools.partial(phase_dist, n_dev=n_dev)
            n = DIST_PER_CARD >> shift
        else:
            make, n = PHASES[name], FULL[name] >> shift
        run_phase(name, make, n, seed, devices)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of one-card phases (default: all)")
    args = ap.parse_args(argv)

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU — JAX found {devs[0].platform!r} "
                 "devices; this script runs only on the card")
    if len(devs) < args.chips:
        sys.exit(f"chip_smoke: --chips {args.chips} needs {args.chips} "
                 f"GPUs, JAX found {len(devs)}")
    print(f"card: {card_line()}", flush=True)
    phases = ["dist"] if args.chips == 4 else args.phases.split(",")
    run(phases, args.seed, n_dev=args.chips)
    d = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()
