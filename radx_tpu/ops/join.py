"""Joins on 32-bit keys (the BASELINE's "hash join", in sort-merge form).

A sort-merge join has the semantics of a hash join and rides the engine's
fastest primitive: the build and probe keys are sorted together once (a
stable CUB pair sort of (key, row) on the GPU), so within every run of
equal keys the build rows come first, in their original order, followed by
the probe rows.  Each probe row then finds its build match with a running
maximum over the run and a gather (ops/core.fill_source) — the
radix-partitioned build/probe of BASELINE config 4 expressed as one sort.

  * join_merge — inner or left join, one match per probe row (duplicate
    build keys resolve to the last build row);
  * join_merge_multi — inner join keeping up to `max_matches` build rows
    per probe row;
  * join_inner — binary-search form (sort the build side, searchsorted).

Results have static shapes: padded arrays plus a valid count or mask.  The
cores take optional traced row counts (rows at or past them are invalid),
so the lazy pipelines (ops/lazy.py) share them.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from radx_tpu.ops import core

_MAX_ROWS = 1 << 30


def _union_sort(enc_b, enc_p, bcount, pcount):
    """Stable sort of [build; probe] by encoded key.  Returns (sorted keys,
    union row of each sorted row, is valid build row, is valid probe row)."""
    nb = enc_b.shape[0]
    sk, perm = core.argsort_stable(jnp.concatenate([enc_b, enc_p]))
    is_build = perm < (nb if bcount is None else bcount)
    is_probe = perm >= nb
    if pcount is not None:
        is_probe = is_probe & (perm - nb < pcount)
    return sk, perm, is_build, is_probe


def _take(col, rows):
    """col[rows] with rows clipped into range (garbage rows stay harmless)."""
    return col[jnp.clip(rows, 0, col.shape[0] - 1)]


def join_core(enc_b, build_vals, bcount, enc_p, probe_vals, pcount,
              how: str = "inner", missing=None):
    """Single-match join.  Returns (keys, build_vals, probe_vals, count):
    the kept probe rows in key order (ties in probe order) first."""
    nb = enc_b.shape[0]
    sk, perm, is_build, is_probe = _union_sort(enc_b, enc_p, bcount, pcount)
    src = core.fill_source(is_build, core.run_starts(sk))
    brow = jnp.where(src >= 0, _take(perm, src), -1)
    keep = is_probe if how == "left" else is_probe & (src >= 0)
    (k, brow, prow), count = core.compact(keep, [sk, brow, perm - nb])
    bval = _take(build_vals, brow)
    if how == "left":
        bval = jnp.where(brow >= 0, bval, missing)
    return k, bval, _take(probe_vals, prow), count


def join_multi_core(enc_b, build_vals, bcount, enc_p, probe_vals, pcount,
                    max_matches: int):
    """Bounded multi-match join over the sorted union.  Returns (keys (n,),
    build_vals (M, n), probe_vals (n,), valid (M, n), truncated):
    valid[j, i] marks sorted row i as a probe row with a rank-j build
    match; truncated is True when a key has more than M valid build rows.
    """
    nb = enc_b.shape[0]
    n = nb + enc_p.shape[0]
    sk, perm, is_build, is_probe = _union_sort(enc_b, enc_p, bcount, pcount)
    pos = jax.lax.iota(jnp.int32, n)
    start = jax.lax.cummax(jnp.where(core.run_starts(sk), pos, 0))
    # valid build rows lead their run, so the rank-j build match of any
    # row sits at start + j, and the builds seen so far count them
    seen = jnp.cumsum(is_build, dtype=jnp.int32)
    builds = seen - seen[start] + is_build[start].astype(jnp.int32)
    truncated = jnp.any(is_build & (builds > max_matches))
    j = jax.lax.broadcasted_iota(jnp.int32, (max_matches, n), 0)
    valid = is_probe[None, :] & (j < builds[None, :])
    src = jnp.minimum(start[None, :] + j, n - 1)
    zero_b = jnp.zeros((), build_vals.dtype)
    fills = jnp.where(valid, _take(build_vals, _take(perm, src)), zero_b)
    pvals = jnp.where(
        is_probe, _take(probe_vals, perm - nb), jnp.zeros((), probe_vals.dtype)
    )
    return sk, fills, pvals, valid, truncated


def expand_matches(keys, fills, pvals, valid):
    """Compact the (row, rank) matches of join_multi_core into flat rows:
    key order, the match ranks of a probe row adjacent.  Returns (keys,
    build_vals, probe_vals, count)."""
    m = fills.shape[0]
    (k, b, p), count = core.compact(
        valid.T.reshape(-1),
        [jnp.repeat(keys, m), fills.T.reshape(-1), jnp.repeat(pvals, m)],
    )
    return k, b, p, count


@functools.partial(jax.jit, static_argnames=("how",))
def _join_merge_jit(enc_b, build_vals, enc_p, probe_vals, bcount, missing,
                    how):
    return join_core(enc_b, build_vals, bcount, enc_p, probe_vals, None,
                     how, missing)


@functools.partial(jax.jit, static_argnames=("max_matches",))
def _join_multi_jit(enc_b, build_vals, enc_p, probe_vals, bcount,
                    max_matches):
    return join_multi_core(enc_b, build_vals, bcount, enc_p, probe_vals,
                           None, max_matches)


def _prepare(build_keys, build_vals, probe_keys, probe_vals):
    build_keys, probe_keys, build_vals, probe_vals = (
        jnp.asarray(x) for x in (build_keys, probe_keys, build_vals,
                                 probe_vals)
    )
    if build_keys.dtype != probe_keys.dtype:
        raise TypeError("join key dtypes must match on both sides")
    enc_b = core.encode_keys(build_keys)  # uint32 / int32 / float32
    enc_p = core.encode_keys(probe_keys)
    if build_vals.shape != build_keys.shape:
        raise ValueError("build_vals must match build_keys")
    if probe_vals.shape != probe_keys.shape:
        raise ValueError("probe_vals must match probe_keys")
    if build_keys.shape[0] >= _MAX_ROWS or probe_keys.shape[0] >= _MAX_ROWS:
        raise ValueError("joins support up to 2^30-1 rows per side")
    # an empty build side joins as one invalid row (bcount = 0)
    bcount = None
    if build_keys.shape[0] == 0:
        enc_b = jnp.zeros((1,), jnp.uint32)
        build_vals = jnp.zeros((1,), build_vals.dtype)
        bcount = jnp.int32(0)
    return enc_b, build_vals, enc_p, probe_vals, bcount


def join_merge(build_keys, build_vals, probe_keys, probe_vals,
               how: str = "inner", missing=None):
    """Scalable inner or left join (single match per probe row).

    how="left" keeps EVERY probe row (SQL LEFT JOIN): unmatched rows carry
    `missing` as the build value (default: zero of build_vals' dtype).
    Right joins are the same call with the sides swapped.  Duplicate build
    keys resolve to the *last* build row.

    Returns (keys, build_vals, probe_vals, count): the first `count` rows
    are the output (key order, ties in probe order).

    Keys may be uint32 / int32 / float32 (both sides the same dtype):
    non-uint32 keys run through the order-preserving encodings of
    ops/core.encode_keys; float32 keys match by BIT PATTERN (-0.0 and +0.0
    are distinct; nan == nan for the same payload bits).
    """
    if how not in ("inner", "left"):
        raise ValueError(f"how must be 'inner' or 'left', got {how!r}")
    key_dtype = jnp.asarray(build_keys).dtype
    enc_b, bvals, enc_p, pvals, bcount = _prepare(
        build_keys, build_vals, probe_keys, probe_vals
    )
    missing = jnp.asarray(0 if missing is None else missing, bvals.dtype)
    if enc_p.shape[0] == 0:
        return (jnp.zeros((0,), key_dtype), bvals[:0], pvals, jnp.int32(0))
    k, bv, pv, count = _join_merge_jit(
        enc_b, bvals, enc_p, pvals, bcount, missing, how
    )
    return core.decode_keys(k, key_dtype), bv, pv, count


def join_merge_multi(build_keys, build_vals, probe_keys, probe_vals,
                     max_matches: int = 4):
    """Scalable inner join with bounded duplicate build keys.

    Returns (keys, build_vals, probe_vals, valid, truncated):
      keys/probe_vals: (n,) key-sorted union rows (n = nb + np);
      build_vals: (max_matches, n) — row j holds the rank-j build match;
      valid: (max_matches, n) bool — valid[j, i] marks a real (probe i,
        build rank j) output row;
      truncated: True if some key has more than max_matches build rows
        (matches beyond the bound are dropped; re-run with a larger bound).
    """
    if max_matches < 1:
        raise ValueError("max_matches must be >= 1")
    key_dtype = jnp.asarray(build_keys).dtype
    enc_b, bvals, enc_p, pvals, bcount = _prepare(
        build_keys, build_vals, probe_keys, probe_vals
    )
    k, bv, pv, valid, trunc = _join_multi_jit(
        enc_b, bvals, enc_p, pvals, bcount, max_matches
    )
    return core.decode_keys(k, key_dtype), bv, pv, valid, trunc


@functools.partial(jax.jit, static_argnames=("max_matches",))
def _join_jit(build_keys, build_vals, probe_keys, probe_vals, max_matches):
    nb = build_keys.shape[0]
    sk, sv = core.sort_pairs_stable(build_keys, build_vals)
    lo = jnp.searchsorted(sk, probe_keys, side="left")
    hi = jnp.searchsorted(sk, probe_keys, side="right")
    counts = (hi - lo).astype(jnp.int32)

    # expand up to max_matches per probe row
    j = jax.lax.broadcasted_iota(jnp.int32, (probe_keys.shape[0], max_matches), 1)
    idx = jnp.clip(lo[:, None] + j, 0, nb - 1)
    valid = j < jnp.minimum(counts, max_matches)[:, None]
    out_bk = jnp.where(valid, sk[idx], jnp.uint32(0))
    out_bv = jnp.where(valid, sv[idx], jnp.zeros((), sv.dtype))
    out_pv = jnp.where(valid, probe_vals[:, None], jnp.zeros((), probe_vals.dtype))
    truncated = jnp.any(counts > max_matches)
    return out_bk, out_bv, out_pv, valid, truncated


def join_inner(build_keys, build_vals, probe_keys, probe_vals,
               max_matches: int = 4):
    """Inner join: rows (probe i, build j) with probe_keys[i]==build_keys[j].

    Returns (key, build_val, probe_val, valid_mask, truncated):
    shape (n_probe, max_matches) padded tables; `valid_mask` marks real
    matches; `truncated` is True if any probe key had more than max_matches
    build matches (re-run with a larger max_matches).
    """
    if max_matches < 1:
        raise ValueError("max_matches must be >= 1")
    key_dtype = jnp.asarray(build_keys).dtype
    enc_b, bvals, enc_p, pvals, bcount = _prepare(
        build_keys, build_vals, probe_keys, probe_vals
    )
    if bcount is not None:
        raise ValueError("join_inner needs a non-empty build side")
    out_bk, out_bv, out_pv, valid, trunc = _join_jit(
        enc_b, bvals, enc_p, pvals, max_matches
    )
    return core.decode_keys(out_bk, key_dtype), out_bv, out_pv, valid, trunc
