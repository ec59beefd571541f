"""unique / distinct — deduplication operators over the sort + compaction
primitives.

Query-executor surface (SELECT DISTINCT): absent from the reference (a bare
sort library, SURVEY §2) but a standard demand on a sorted-data engine, and
free to build here: sorted boundary detection is one shifted compare, and the
compaction is the same prefix-sum scatter that powers filter and groupby
(ops/core.py).

Because XLA requires static shapes, both operators return padded arrays
plus a valid count, like ops/filter.filter_columns; `Table.distinct` slices
eagerly via int(count).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from radx_tpu.ops import core


@functools.partial(jax.jit, static_argnames=("with_counts",))
def _unique_jit(enc, with_counts: bool):
    n = enc.shape[0]
    s = jax.lax.sort(enc)
    first = core.run_starts(s)
    cols = [s]
    if with_counts:
        cols.append(jax.lax.iota(jnp.int32, n))
    outs, count = core.compact(first, cols)
    if not with_counts:
        return outs[0], count
    # counts[g] = start of group g+1 minus start of group g; the last valid
    # group ends at n.  Tail entries (>= count) are garbage, like the keys.
    starts = outs[1]
    nexts = jnp.concatenate([starts[1:], starts[:1]])
    g = jax.lax.iota(jnp.int32, n)
    ends = jnp.where(g == count - 1, jnp.int32(n), nexts)
    return outs[0], ends - starts, count


def unique(keys, return_counts: bool = False):
    """Sorted distinct values of a uint32 / int32 / float32 array.

    Returns (values, count) — or (values, counts, count) with
    return_counts=True — where only the first `count` entries are valid
    (static shapes; the tail is garbage).  Float semantics follow the
    engine's total order: -0.0 and +0.0 are distinct values, all NaN
    bit-patterns of one sign collapse per bit-pattern (bitwise dedup).
    """
    keys = jnp.asarray(keys)
    enc = core.encode_keys(keys)
    if keys.shape[0] == 0:
        raise ValueError("unique needs at least one element")
    res = _unique_jit(enc, return_counts)
    vals = core.decode_keys(res[0], keys.dtype)
    return (vals, *res[1:])
