"""Chunked (streaming) relational operators — BASELINE config 3 at 1B rows.

These wrappers stream host-resident columns through the single-call
operators in slabs, merging the per-slab results on the host (filter), with
a recursive second aggregation pass (groupby), or with a pairwise device
merge tree (sort).  They bound device memory by the slab size instead of
the table size.  The reference has no analogue — its maxElementCount is fixed at
initialize() time (radx_internal.hpp:115-119) and it never exceeds one
buffer — but BASELINE.json demands the 1B-row configs on a single host.

Semantics match the unchunked operators exactly:
  * filter_chunked == filter_columns: stable compaction (slab order is
    preserved, and slabs are processed in order).
  * groupby_chunked == groupby: per-slab partial aggregates are re-aggregated
    by key (count partials are summed); associativity of sum/min/max/count
    makes the merge exact.  float32 sums differ from the unchunked op only
    by reduction order (both deterministic).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from radx_tpu.ops.filter import filter_columns
from radx_tpu.ops.groupby import groupby

_SLAB = 1 << 28


def filter_chunked(mask, cols, slab: int = _SLAB):
    """Stable compaction of host-resident 32-bit columns by a 0/1 mask.

    mask/cols: numpy arrays (kept on host; slabs are shipped to the device
    one at a time).  Returns (cols_out, count) with cols_out host numpy
    arrays of length count — exact, no padding.
    """
    mask = np.asarray(mask)
    n = mask.shape[0]
    outs = [[] for _ in cols]
    total = 0
    for lo in range(0, n, slab):
        hi = min(lo + slab, n)
        m_d = jnp.asarray(mask[lo:hi])
        c_d = [jnp.asarray(np.asarray(c)[lo:hi]) for c in cols]
        comp, cnt = filter_columns(m_d, c_d)
        cnt = int(cnt)
        total += cnt
        for o, c in zip(outs, comp):
            o.append(np.asarray(jax.device_get(c[:cnt])))
    return [np.concatenate(o) if o else np.empty((0,)) for o in outs], total


def groupby_chunked(
    keys,
    values,
    agg: str = "sum",
    slab: int = _SLAB,
):
    """Aggregate host-resident values per unique uint32 key, slab-streamed.

    Returns (unique_keys, aggregates, num_groups) as exact-length host numpy
    arrays.  Partial per-slab aggregates are merged with a second pass
    (recursively chunked when the partials themselves exceed one slab, e.g.
    all-unique keys) — `count` partials merge via `sum`.
    """
    keys = np.asarray(keys)
    values = np.asarray(values)
    n = keys.shape[0]
    if n <= slab:
        uk, out, ng = groupby(jnp.asarray(keys), jnp.asarray(values), agg)
        ng = int(ng)
        return (
            np.asarray(jax.device_get(uk[:ng])),
            np.asarray(jax.device_get(out[:ng])),
            ng,
        )
    uks, parts = [], []
    for lo in range(0, n, slab):
        hi = min(lo + slab, n)
        uk, out, ng = groupby(
            jnp.asarray(keys[lo:hi]), jnp.asarray(values[lo:hi]), agg
        )
        ng = int(ng)
        uks.append(np.asarray(jax.device_get(uk[:ng])))
        parts.append(np.asarray(jax.device_get(out[:ng])))
    merged_k = np.concatenate(uks)
    merged_v = np.concatenate(parts)
    merge_agg = "sum" if agg == "count" else agg
    if merged_k.shape[0] > max(slab, (3 * n) // 4):
        # Near-unique keys: recursing wouldn't shrink the problem (the
        # device merge needs the very global sort we're slab-dodging), so
        # finish the (already slab-reduced) merge on the host — exact.
        return _host_merge(merged_k, merged_v, merge_agg)
    return groupby_chunked(merged_k, merged_v, merge_agg, slab)


def sort_chunked(keys, slab: int = _SLAB):
    """Out-of-core ascending sort of host-resident uint32 keys.

    Each slab is sorted on the device; then a pairwise merge tree folds the
    sorted runs, each merge one device sort of two concatenated runs, until
    one run remains.  Host RAM holds the runs between levels, so the device
    never holds more than two slabs.

    Closes the top of the 1M–1B parity range (BASELINE north star;
    the reference's maxElementCount contract, radx_internal.hpp:115-119).
    """
    keys = np.asarray(keys)
    if keys.dtype != np.uint32:
        raise TypeError("sort_chunked keys must be uint32")
    runs = [
        np.asarray(jax.device_get(_sort_run(jnp.asarray(keys[lo : lo + slab]))))
        for lo in range(0, keys.shape[0], slab)
    ]
    while len(runs) > 1:
        runs = [
            np.asarray(jax.device_get(
                _sort_run(jnp.asarray(np.concatenate(runs[j : j + 2])))
            ))
            for j in range(0, len(runs), 2)
        ]
    return runs[0] if runs else keys


@jax.jit
def _sort_run(keys):
    return jax.lax.sort(keys)


def _host_merge(keys, vals, agg):
    order = np.argsort(keys, kind="stable")
    k, v = keys[order], vals[order]
    starts = np.flatnonzero(np.concatenate([[True], k[1:] != k[:-1]]))
    uk = k[starts]
    ufunc = {
        "sum": np.add,
        "min": np.minimum,
        "max": np.maximum,
    }[agg]
    out = ufunc.reduceat(v, starts)
    return uk, out.astype(vals.dtype), uk.shape[0]
