"""Plain XLA building blocks shared by every operator, eager and lazy.

Each relational operator in ``ops/`` and ``parallel/`` is composed from four
primitives:

  * a stable sort of (uint32 key, value) pairs.  ``lax.sort`` with one key
    operand, one value operand and ``is_stable=True`` is the form that XLA's
    GPU backend rewrites into CUB's ``DeviceRadixSort`` — an LSD radix sort
    of the same family as RadX's 4-pass 8-bit pipeline (SURVEY §1).  Wider
    rows ride as an int32 permutation and one gather per column;
    lexicographic keys are LSD passes of that same sort.
  * stable compaction: a prefix sum of the mask gives every kept row its
    slot, and one scatter moves it there.
  * runs of equal keys in a sorted array: boundary flags, and a segmented
    associative scan that folds each run (read at the run's last row).
  * forward fill inside runs: a running maximum of marked positions.

The same code runs on the CPU backend in tests and on the GPU; nothing here
branches on the platform.  Every function is traceable (static shapes; counts
stay traced), so eager operators and the single-jit ``LazyTable`` pipelines
share them.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_SIGN = np.uint32(0x80000000)


def _iota(n: int):
    return jax.lax.iota(jnp.int32, n)


def sort_pairs_stable(keys, values):
    """Stable sort of `values` by uint32 `keys`: one CUB pair sort on the
    GPU.  Returns (sorted_keys, sorted_values)."""
    return jax.lax.sort((keys, values), num_keys=1, is_stable=True)


def argsort_stable(keys):
    """Stable argsort of uint32 `keys`.  Returns (sorted_keys, perm) with
    perm int32: ties keep their original order."""
    return sort_pairs_stable(keys, _iota(keys.shape[0]))


def lex_argsort(keys):
    """Stable argsort by several uint32 key columns, most significant first:
    one stable pair sort per column, least significant first (the LSD
    argument of the reference's digit pipeline, radx_implement.inl:421-447,
    lifted from 8-bit digits to 32-bit columns)."""
    perm = None
    for k in reversed(keys):
        _, p = argsort_stable(k if perm is None else k[perm])
        perm = p if perm is None else perm[p]
    return perm


def sort_by_key(keys, cols):
    """Stable sort of `cols` (any dtypes, same length) by uint32 `keys`.
    Returns (sorted_keys, sorted_cols)."""
    if len(cols) == 1:
        sk, sc = sort_pairs_stable(keys, cols[0])
        return sk, [sc]
    sk, perm = argsort_stable(keys)
    return sk, [c[perm] for c in cols]


def compact(mask, cols):
    """Stable compaction: rows where `mask` is nonzero move to the front,
    in order.  Returns (cols, count); rows from `count` on are zero."""
    keep = mask != 0
    n = keep.shape[0]
    pos = jnp.cumsum(keep, dtype=jnp.int32)
    dest = jnp.where(keep, pos - 1, n)
    outs = [jnp.zeros_like(c).at[dest].set(c, mode="drop") for c in cols]
    return outs, pos[-1]


def valid_rows(n: int, count):
    """Rows [0, count) of a length-n padded column are valid."""
    return _iota(n) < count


def invalid_last(keys, count):
    """uint32 sort keys with rows at or past `count` set to the maximum
    key.  A stable sort then keeps every invalid row behind every valid
    row, even one whose key is the maximum, because the valid rows are a
    prefix."""
    return jnp.where(valid_rows(keys.shape[0], count), keys,
                     jnp.uint32(0xFFFFFFFF))


def run_starts(sorted_keys, count=None):
    """True where a row of `sorted_keys` starts a run of equal keys; rows at
    or past `count` never start one."""
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_keys[1:] != sorted_keys[:-1]]
    )
    if count is not None:
        first = first & valid_rows(sorted_keys.shape[0], count)
    return first


def run_ends(first, count=None):
    """True where a row ends its run: the next row starts a run, or is past
    `count`, or does not exist."""
    n = first.shape[0]
    nxt = jnp.concatenate([first[1:], jnp.ones((1,), bool)])
    if count is None:
        return nxt
    pos = _iota(n)
    return (pos < count) & (nxt | (pos + 1 >= count))


def order_i32(values):
    """uint32 / int32 / float32 values → int32 whose signed order is the
    values' order (float32: -inf < ... < -0.0 < +0.0 < ... < +inf < nan)."""
    return jax.lax.bitcast_convert_type(encode_keys(values) ^ _SIGN, jnp.int32)


def order_i32_decode(oi32, dtype):
    enc = jax.lax.bitcast_convert_type(oi32, jnp.uint32) ^ _SIGN
    return decode_keys(enc, dtype)


_FOLDS = {"sum": jnp.add, "min": jnp.minimum, "max": jnp.maximum}


def run_scan(values, first, op: str):
    """Inclusive scan within runs that start where `first`: each row gets
    the sum / min / max of its run up to itself.  A segmented
    associative_scan — a fixed tree order, so float sums are
    deterministic."""
    fold = _FOLDS[op]

    def combine(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, fold(va, vb))

    return jax.lax.associative_scan(combine, (first, values))[1]


def run_aggregate(values, first, agg: str):
    """run_scan for the group-by aggregations: count is int32, integer sums
    wrap mod 2^32, and min/max compare in the values' order (order_i32)."""
    if agg == "count":
        return run_scan(jnp.ones(first.shape, jnp.int32), first, "sum")
    if agg == "sum":
        return run_scan(values, first, "sum")
    return order_i32_decode(run_scan(order_i32(values), first, agg),
                            values.dtype)


def fill_source(mark, first):
    """For each row, the position of the last row at or before it, within
    its run, where `mark` is true; -1 where there is none."""
    pos = _iota(mark.shape[0])
    last = jax.lax.cummax(jnp.where(mark, pos, -1))
    start = jax.lax.cummax(jnp.where(first, pos, 0))
    return jnp.where(last >= start, last, -1)


def encode_keys(keys):
    """Order-preserving uint32 encoding for supported key dtypes.

    uint32: identity; int32: flip sign bit; float32: sign-magnitude to
    lexicographic (non-negative -> set sign bit, negative -> complement) —
    total order with -inf < ... < -0.0 < +0.0 < ... < +inf < nan.
    """
    keys = jnp.asarray(keys)
    if keys.ndim != 1:
        raise ValueError("keys must be 1-D")
    if keys.dtype == jnp.uint32:
        return keys
    if keys.dtype == jnp.int32:
        return jax.lax.bitcast_convert_type(keys, jnp.uint32) ^ _SIGN
    if keys.dtype == jnp.float32:
        bits = jax.lax.bitcast_convert_type(keys, jnp.uint32)
        return jnp.where((bits & _SIGN) != 0, ~bits, bits | _SIGN)
    raise TypeError(f"unsupported key dtype {keys.dtype}")


def decode_keys(enc, dtype):
    if dtype == jnp.uint32:
        return enc
    if dtype == jnp.int32:
        return jax.lax.bitcast_convert_type(enc ^ _SIGN, jnp.int32)
    bits = jnp.where((enc & _SIGN) != 0, enc ^ _SIGN, ~enc)
    return jax.lax.bitcast_convert_type(bits, jnp.float32)
