"""Group-by aggregation (the BASELINE's "hash aggregate").

Two forms with one semantics:

  * ``groupby`` — sort-based: one stable (key, value) sort (a CUB pair sort
    on the GPU), run boundaries by one shifted compare, and a segmented
    scan that folds each run (ops/core.py).  The digit-histogram machinery
    the reference uses per pass (counting.comp) reappears as the
    boundary/segment bookkeeping.
  * ``groupby_dense`` — for key spaces bounded by `bins`: the keys are the
    segment ids, so one segment reduction (a scatter) of the unsorted rows
    is the whole aggregate.

Aggregations: sum, count, min, max over uint32 / int32 / float32 values.
Integer sums wrap mod 2^32; min/max compare in the values' total order
(float32: -inf < ... < -0.0 < +0.0 < ... < +inf < nan); float32 sums
accumulate in float32 (groupby: a fixed tree order; groupby_dense: an
unspecified order).  Outputs are padded to the input length with
`num_groups` valid rows (static shapes — XLA cannot return data-dependent
sizes).

The cores take an optional traced `count` (rows at or past it are invalid),
so the eager API and the lazy pipelines (ops/lazy.py) share them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from radx_tpu.ops import core

AGGS = ("sum", "count", "min", "max")
MAX_BINS = 1 << 24
SPREAD_SLOTS = 1 << 16  # scatter targets of the dense aggregate (at least)


def groupby_core(enc, values, count, agg: str):
    """Sort-based aggregation of `values` by encoded uint32 keys `enc`.

    Invalid rows (at or past `count`; LazyTable rows are a valid prefix)
    sort last (core.invalid_last), so the first `count` sorted rows are
    exactly the valid ones.  Returns (unique encoded keys, aggregates,
    num_groups)."""
    if count is not None:
        enc = core.invalid_last(enc, count)
    sk, sv = core.sort_pairs_stable(enc, values)
    first = core.run_starts(sk, count)
    acc = core.run_aggregate(sv, first, agg)
    (uk, out), num_groups = core.compact(core.run_ends(first, count), [sk, acc])
    return uk, out, num_groups


def dense_aggregate(keys, values, bins: int, agg: str, count=None):
    """Per-bin aggregate and row count of `values` keyed by uint32 bin ids
    (keys >= bins, and rows at or past `count`, are dropped).  Returns
    (aggregates (bins,), counts (bins,) int32); empty bins hold the
    reduction's identity.

    Each bin is spread over `spread` slots (row i goes to slot i % spread)
    so that at most SPREAD_SLOTS scatter targets share the rows: with few
    bins, a plain scatter funnels every row's atomic update into the same
    few addresses."""
    n = keys.shape[0]
    spread = max(1, SPREAD_SLOTS // bins)
    ids = jnp.where(keys < bins, keys, bins).astype(jnp.int32)
    if count is not None:
        ids = jnp.where(core.valid_rows(n, count), ids, bins)
    ids = ids * spread + jax.lax.iota(jnp.int32, n) % spread
    slots = bins * spread

    def fold(scatter, x, reduce):
        return reduce(scatter(x, ids, num_segments=slots).reshape(bins, spread),
                      axis=1)

    counts = fold(jax.ops.segment_sum, jnp.ones((n,), jnp.int32), jnp.sum)
    if agg == "count":
        return counts, counts
    if agg == "sum":
        return fold(jax.ops.segment_sum, values, jnp.sum), counts
    scatter, reduce = (
        (jax.ops.segment_min, jnp.min) if agg == "min"
        else (jax.ops.segment_max, jnp.max)
    )
    ext = fold(scatter, core.order_i32(values), reduce)
    return core.order_i32_decode(ext, values.dtype), counts


def groupby_dense_core(keys, values, count, agg: str, bins: int):
    """dense_aggregate, compacted to the present bins.  Returns (bin ids
    uint32, aggregates, num_groups)."""
    out, counts = dense_aggregate(keys, values, bins, agg, count)
    bin_ids = jax.lax.iota(jnp.uint32, bins)
    (uk, out), ng = core.compact(counts > 0, [bin_ids, out])
    return uk, out, ng


@functools.partial(jax.jit, static_argnames=("agg",))
def _groupby_jit(enc, values, agg: str):
    return groupby_core(enc, values, None, agg)


@functools.partial(jax.jit, static_argnames=("agg", "bins"))
def _groupby_dense_jit(keys, values, agg: str, bins: int):
    uk, out, ng = groupby_dense_core(keys, values, None, agg, bins)
    return uk, out, ng, jnp.max(keys) < jnp.uint32(bins)


def _check(values, keys, agg):
    if values.dtype not in (jnp.uint32, jnp.int32, jnp.float32):
        raise TypeError("values must be uint32/int32/float32")
    if values.shape != keys.shape:
        raise ValueError("values must match keys shape")
    if agg not in AGGS:
        raise ValueError(f"unknown agg {agg!r}")


def groupby_dense(keys, values, agg: str = "sum", bins: int = 65536):
    """Aggregate for key spaces bounded by `bins`: keys are uint32/int32 bin
    ids in [0, bins), and the result lists the present bins in ascending
    order.  One segment reduction over the rows, no sort.  Semantics match
    `groupby` exactly.  Raises ValueError if any key >= bins.
    """
    keys = jnp.asarray(keys)
    values = jnp.asarray(values)
    key_dtype = keys.dtype
    if keys.dtype == jnp.int32:
        # negatives bitcast to huge uint32 and fail the range check below
        keys = jax.lax.bitcast_convert_type(keys, jnp.uint32)
    if keys.dtype != jnp.uint32:
        raise TypeError("dense groupby keys must be uint32/int32 bin ids")
    _check(values, keys, agg)
    if not 1 <= bins <= MAX_BINS:
        raise ValueError(f"bins must be in [1, {MAX_BINS}]")
    if keys.shape[0] == 0:
        return keys, values, jnp.int32(0)
    uk, out, ng, in_range = _groupby_dense_jit(keys, values, agg, bins)
    if not bool(in_range):
        raise ValueError(f"groupby_dense requires every key < bins={bins}")
    if key_dtype == jnp.int32:  # bin ids < 2^24: bitcast is the identity
        uk = jax.lax.bitcast_convert_type(uk, jnp.int32)
    return uk, out, ng


def groupby(keys, values, agg: str = "sum"):
    """Aggregate `values` per unique key (uint32 / int32 / float32 keys).

    Returns (unique_keys, aggregates, num_groups): arrays of len(keys) —
    rows beyond num_groups are garbage.  Unique keys are ascending (in the
    key dtype's order; float32 keys use the total order -inf < ... < +inf <
    nan, with -0.0 and +0.0 DISTINCT groups — bit-pattern grouping).

    Non-uint32 keys run through the same order-preserving bit encodings as
    sort_any (ops/core.encode_keys) — the reference is uint32-only, SURVEY
    §2; dtype coverage is part of the query-executor surface.
    """
    keys = jnp.asarray(keys)
    values = jnp.asarray(values)
    enc = core.encode_keys(keys)  # validates the key dtype
    _check(values, keys, agg)
    if keys.shape[0] == 0:
        return keys, values, jnp.int32(0)
    uk, out, ng = _groupby_jit(enc, values, agg)
    return core.decode_keys(uk, keys.dtype), out, ng
