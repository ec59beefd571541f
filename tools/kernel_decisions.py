"""Time each operator's plain XLA form against its alternatives on the GPU.

    python tools/kernel_decisions.py [--log2n 28]

Prints one JSON line per measurement: what was timed, the variant, n, the
median seconds of 9 calls (each ended by block_until_ready) and their
spread.  Variants of one decision are checked to agree before they are
timed.  First it records peak_bytes_in_use of filter_columns and groupby at
2^30 rows (does the 1B-row config need ops/chunked.py on this card?).

The decisions it informs are recorded in PERF.md ("Kernel decisions"),
with the numbers of a form since removed (a Pallas Triton dense-aggregate
kernel).
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from radx_tpu import bench_suite, runtime  # noqa: E402
from radx_tpu.ops import core, groupby as groupby_ops  # noqa: E402
from radx_tpu.utils.timing import time_calls  # noqa: E402


def emit(what, variant, n, fn, *args, jit=True):
    times = time_calls(jax.jit(fn) if jit else fn, *args)
    med = statistics.median(times)
    print(json.dumps({
        "what": what, "variant": variant, "n": n, "median_s": med,
        "spread_pct": 100.0 * (max(times) - min(times)) / med,
    }), flush=True)


def agree(*outs):
    first = jax.tree.leaves(jax.device_get(outs[0]))
    for o in outs[1:]:
        for a, b in zip(first, jax.tree.leaves(jax.device_get(o))):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --- alternatives -----------------------------------------------------------


def compact_nonzero(mask, cols):
    n = mask.shape[0]
    idx = jnp.nonzero(mask != 0, size=n, fill_value=0)[0]
    count = jnp.sum(mask != 0, dtype=jnp.int32)
    keep = jnp.arange(n) < count
    return [jnp.where(keep, c[idx], 0) for c in cols], count


def compact_index_gather(mask, cols):
    keep = mask != 0
    n = keep.shape[0]
    pos = jnp.cumsum(keep, dtype=jnp.int32)
    dest = jnp.where(keep, pos - 1, n)
    src = jnp.zeros((n,), jnp.int32).at[dest].set(
        jnp.arange(n, dtype=jnp.int32), mode="drop"
    )
    live = jnp.arange(n) < pos[-1]
    return [jnp.where(live, c[src], 0) for c in cols], pos[-1]


def segsum_scan(sk, sv):
    """Per-run sums by a segmented associative scan, read at run ends (the
    form groupby uses)."""
    first = core.run_starts(sk)
    (out,), ng = core.compact(core.run_ends(first),
                              [core.run_scan(sv, first, "sum")])
    return out, ng


def segsum_segment(sk, sv):
    """Per-run sums by a scatter-add over the run numbers."""
    first = core.run_starts(sk)
    ids = jnp.cumsum(first, dtype=jnp.int32) - 1
    out = jax.ops.segment_sum(sv, ids, num_segments=sk.shape[0],
                              indices_are_sorted=True)
    return out, jnp.sum(first, dtype=jnp.int32)


def topk_sort(work, k):
    sk, perm = core.argsort_stable(work)
    return sk[:k], perm[:k]


def topk_lax(work, k):
    v, i = jax.lax.top_k(~work, k)
    return ~v, i


def multi_gather(key, cols):
    return core.sort_by_key(key, cols)


def multi_operands(key, cols):
    out = jax.lax.sort((key, *cols), num_keys=1, is_stable=True)
    return out[0], list(out[1:])


def u64_lsd(hi, lo):
    perm = core.lex_argsort([hi, lo])
    return hi[perm], lo[perm]


def u64_two_keys(hi, lo):
    return tuple(jax.lax.sort((hi, lo), num_keys=2))


def dense_sum_xla(keys, vals, bins):
    """The groupby_dense form: a scatter-add over bins spread into at least
    2^16 slots."""
    return groupby_ops.dense_aggregate(keys, vals, bins, "sum")[0]


def dense_sum_plain_scatter(keys, vals, bins):
    """One scatter-add straight into the bins."""
    return jax.ops.segment_sum(vals, keys.astype(jnp.int32), num_segments=bins)


# --- measurements -------------------------------------------------------------


def peaks(log2n):
    """peak_bytes_in_use after filter_columns, then after groupby, at
    2^log2n rows (cumulative: the second includes the first)."""
    import radx_tpu as rx

    n = 1 << log2n
    dev = jax.devices()[0]
    keys = jnp.asarray(runtime.gen_uniform(n, 1) % np.uint32(1 << 20))
    vals = jnp.asarray(runtime.gen_uniform(n, 2))
    jax.block_until_ready(rx.filter_columns(vals & 1, [keys, vals]))
    f_peak = dev.memory_stats()["peak_bytes_in_use"]
    jax.block_until_ready(rx.groupby(keys, vals, "sum"))
    g_peak = dev.memory_stats()["peak_bytes_in_use"]
    print(json.dumps({"what": "peak_bytes_in_use", "n": n,
                      "filter_2cols": f_peak, "groupby_sum": g_peak}),
          flush=True)


SECTIONS = ("sort", "compact", "groupby", "topk", "multi", "u64", "dense")


def variants(log2n, sections=SECTIONS):
    import radx_tpu as rx

    n = 1 << log2n
    u = jnp.asarray(runtime.gen_uniform(n, 3))
    v = jnp.asarray(runtime.gen_uniform(n, 4))
    keys20 = u % jnp.uint32(1 << 20)  # 2^20 distinct keys, ~256 rows each

    if "sort" in sections:
        sort_section(n, u, v)
    if "compact" in sections:
        compact_section(n, u, v)
    if "groupby" in sections:
        groupby_section(n, keys20, v, rx)
    if "topk" in sections:
        topk_section(n, keys20)
    if "multi" in sections:
        multi_section(n, u, v, keys20)
    if "u64" in sections:
        u64_section(n, u, v)
    if "dense" in sections:
        dense_section(n, u, v, rx)


def sort_section(n, u, v):
    emit("sort", "lax.sort u32", n, jax.lax.sort, u)
    emit("sort", "argsort stable (CUB pairs)", n,
         lambda k: core.argsort_stable(k)[1], u)
    emit("sort", "sort_pairs stable (CUB pairs)", n, core.sort_pairs_stable,
         u, v)


def compact_section(n, u, v):
    """Compaction: filter, distinct and every result compaction."""
    mask = (u & 1).astype(jnp.int32)
    cols = [u, v]
    forms = {"scatter per column": core.compact,
             "nonzero + gather": compact_nonzero,
             "index scatter + gather": compact_index_gather}
    agree(*(jax.jit(f)(mask, cols) for f in forms.values()))
    for name, f in forms.items():
        emit("compact 2 cols 50%", name, n, f, mask, cols)


def groupby_section(n, keys20, v, rx):
    """Per-run sums of sorted pairs (groupby)."""
    sk, sv = jax.jit(core.sort_pairs_stable)(keys20, v)
    a = jax.jit(segsum_segment)(sk, sv)
    b = jax.jit(segsum_scan)(sk, sv)
    agree((a[0][: int(a[1])], a[1]), (b[0][: int(b[1])], b[1]))
    emit("groupby runs sum (2^20 keys)", "segment_sum sorted ids", n,
         segsum_segment, sk, sv)
    emit("groupby runs sum (2^20 keys)", "segmented associative_scan", n,
         segsum_scan, sk, sv)
    emit("groupby end to end", "rx.groupby sum", n,
         lambda k, x: rx.groupby(k, x, "sum"), keys20, v)


def topk_section(n, keys, k=1000):
    forms = {"stable sort + slice": topk_sort, "lax.top_k": topk_lax}
    fns = {name: functools.partial(f, k=k) for name, f in forms.items()}
    agree(*(jax.jit(f)(keys) for f in fns.values()))
    for name, f in fns.items():
        emit(f"top_k k={k}", name, n, f, keys)


def multi_section(n, u, v, keys):
    """Multi-column stable sort (sort_multi, sort_by, the lazy sorts)."""
    mcols = [v, u ^ jnp.uint32(7), v.astype(jnp.float32)]
    agree(jax.jit(multi_gather)(keys, mcols),
          jax.jit(multi_operands)(keys, mcols))
    emit("stable sort + 3 columns", "CUB argsort + gathers", n,
         multi_gather, keys, mcols)
    emit("stable sort + 3 columns", "one lax.sort of 4 operands", n,
         multi_operands, keys, mcols)


def u64_section(n, u, v):
    hi = u % jnp.uint32(1 << 16)
    agree(jax.jit(u64_lsd)(hi, v), jax.jit(u64_two_keys)(hi, v))
    emit("sort_u64", "LSD: 2 CUB pair sorts + gathers", n, u64_lsd, hi, v)
    emit("sort_u64", "lax.sort num_keys=2", n, u64_two_keys, hi, v)


def dense_section(n, u, v, rx):
    for bins in (128, 1024, 65536):
        dk = u % jnp.uint32(bins)
        forms = {"XLA spread scatter (groupby_dense)": dense_sum_xla,
                 "XLA plain scatter": dense_sum_plain_scatter}
        fns = {k: functools.partial(f, bins=bins) for k, f in forms.items()}
        agree(*(jax.jit(f)(dk, v) for f in fns.values()))
        for name, f in fns.items():
            emit(f"dense sum bins={bins}", name, n, f, dk, v)
        emit(f"dense sum bins={bins}", "groupby_dense sum end to end", n,
             lambda k, x: rx.groupby_dense(k, x, "sum", bins), dk, v,
             jit=False)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--log2n", type=int, default=28)
    ap.add_argument("--peak-log2n", type=int, default=30)
    ap.add_argument("--sections", default="peak," + ",".join(SECTIONS))
    args = ap.parse_args()
    sections = args.sections.split(",")
    bench_suite.require_gpu()
    print(json.dumps(bench_suite.device_info()), flush=True)
    if "peak" in sections:
        peaks(args.peak_log2n)
    variants(args.log2n, sections)


if __name__ == "__main__":
    main()
