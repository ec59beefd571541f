"""Lazy columnar pipelines: filter → groupby → join → sort under ONE jit.

The eager `Table` operators call ``int(count)`` after every step to slice
exact row counts — a host sync per operator that blocks fusing a whole
query into one XLA program.  `LazyTable` keeps the padded arrays + a
*traced* row count instead:

  invariant: rows [0, count) are the valid rows, in operator order; rows
  beyond `count` are garbage.  Every operator core (ops/groupby.py,
  ops/join.py, ops/topk.py, ops/core.py) takes the traced count, so no host
  sync is needed between operators.  `collect()` is the single sync at the
  end.

`LazyTable` is a pytree — whole pipelines jit/vmap/grad-compose:

    @jax.jit
    def query(t: LazyTable) -> LazyTable:
        kept = t.filter(t.column("returned") == 0)
        agg = kept.groupby("store", "amount", "sum")
        return agg.sort_by("sum", descending=True)

The validity trick for sorts (ops/core.invalid_last): invalid rows get the
maximum key.  The sort is stable and the valid rows are a prefix, so every
invalid row lands behind every valid row, including valid rows whose key is
the maximum — validity never collides with legal key values.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from radx_tpu.ops import core
from radx_tpu.ops import groupby as groupby_ops
from radx_tpu.ops import join as join_ops
from radx_tpu.ops.topk import top_k_core


# --- operator cores (all shapes static; `count`s traced) -------------------


@jax.jit
def filter_lazy(mask, cols, count):
    """Stable compaction by mask ∧ validity. Returns (cols, new_count)."""
    keep = (mask != 0) & core.valid_rows(mask.shape[0], count)
    return core.compact(keep, list(cols))


@functools.partial(jax.jit, static_argnames=("agg",))
def groupby_lazy(enc, values, count, agg: str):
    """ops/groupby.groupby_core with a traced row count."""
    return groupby_ops.groupby_core(enc, values, count, agg)


@functools.partial(jax.jit, static_argnames=("agg", "bins"))
def groupby_lazy_dense(keys, values, count, agg: str, bins: int):
    """ops/groupby.groupby_dense_core with a traced row count.  Keys past
    the bound among the valid prefix are the caller's contract (they are
    dropped; only the eager API, which may sync, checks them)."""
    return groupby_ops.groupby_dense_core(keys, values, count, agg, bins)


@jax.jit
def join_lazy(build_keys, build_vals, bcount, probe_keys, probe_vals, pcount):
    """ops/join.join_core (inner) with traced row counts. Returns (keys,
    build_vals, probe_vals, count) padded to nb + np; duplicate build keys
    resolve to the last valid build row."""
    return join_ops.join_core(
        build_keys, build_vals, bcount, probe_keys, probe_vals, pcount
    )


@functools.partial(jax.jit, static_argnames=("max_matches",))
def join_multi_lazy(build_keys, build_vals, bcount, probe_keys, probe_vals,
                    pcount, max_matches: int):
    """Bounded multi-match join with traced row counts — the lazy
    counterpart of Table.join(max_matches > 1).

    Returns (keys, build_vals, probe_vals, count, truncated) padded to
    (nb + np) * max_matches; `truncated` is a traced bool — True when a
    VALID build key has more than max_matches valid build rows (the extra
    matches were dropped; callers check it at collect time)."""
    k, fills, pv, valid, truncated = join_ops.join_multi_core(
        build_keys, build_vals, bcount, probe_keys, probe_vals, pcount,
        max_matches,
    )
    return (*join_ops.expand_matches(k, fills, pv, valid), truncated)


@functools.partial(jax.jit, static_argnames=("descending",))
def sort_lazy(enc_keys, cols, count, descending: bool):
    """Stable validity-aware sort by an encoded uint32 key; `cols` ride
    along by one gather each. Count is unchanged."""
    enc = ~enc_keys if descending else enc_keys
    _, outs = core.sort_by_key(core.invalid_last(enc, count), list(cols))
    return outs


@functools.partial(jax.jit, static_argnames=("k",))
def top_k_lazy(work, cols, count, k: int):
    """The k best valid rows of `cols` by `work` (ascending = best first)."""
    _, idx = top_k_core(core.invalid_last(work, count), k)
    return [c[idx] for c in cols]


# --- the LazyTable ----------------------------------------------------------


class LazyTable:
    """Padded columns + traced valid-row count; see module docstring."""

    def __init__(self, columns, count):
        self.columns = dict(columns)
        self.count = jnp.asarray(count, jnp.int32)
        lens = {c.shape[0] for c in self.columns.values()}
        if len(lens) != 1:
            raise ValueError("all columns must have equal padded length")

    # pytree plumbing (column names are static aux data)
    def tree_flatten(self):
        names = tuple(sorted(self.columns))
        return tuple(self.columns[n] for n in names) + (self.count,), names

    @classmethod
    def tree_unflatten(cls, names, children):
        obj = cls.__new__(cls)
        obj.columns = dict(zip(names, children[:-1]))
        obj.count = children[-1]
        return obj

    @classmethod
    def from_table(cls, table) -> "LazyTable":
        return cls(table.columns, jnp.int32(table.num_rows))

    @property
    def padded_rows(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    def column(self, name: str):
        return self.columns[name]

    # -- operators (no host syncs anywhere below) ---------------------------

    def filter(self, mask) -> "LazyTable":
        names = list(self.columns)
        cols, count = filter_lazy(
            jnp.asarray(mask), tuple(self.columns[m] for m in names),
            self.count,
        )
        return LazyTable(dict(zip(names, cols)), count)

    def groupby(self, key: str, value: str, agg: str = "sum",
                bins: int | None = None) -> "LazyTable":
        """GROUP BY key aggregating value (same surface as Table.groupby).

        Pass `bins` (a bound on the key space) to route through the dense
        aggregate — no sort, no sync, same semantics.  Keys past the bound
        among the valid prefix are the caller's contract (checked only in
        the eager API, which is allowed a host sync)."""
        if agg not in groupby_ops.AGGS:
            raise ValueError(f"unknown agg {agg!r}")
        key_col = self.columns[key]
        key_dtype = key_col.dtype
        if bins is not None:
            # dense keys are bin ids: uint32/int32 in [0, bins) — bitcast
            # is the identity there (out-of-range is the caller's contract)
            if key_dtype == jnp.float32:
                raise TypeError("dense groupby keys must be uint32/int32")
            uk, out, ng = groupby_lazy_dense(
                jax.lax.bitcast_convert_type(key_col, jnp.uint32),
                self.columns[value], self.count, agg, bins,
            )
            uk = jax.lax.bitcast_convert_type(uk, key_dtype)
        else:
            uk, out, ng = groupby_lazy(
                core.encode_keys(key_col), self.columns[value], self.count,
                agg,
            )
            uk = core.decode_keys(uk, key_dtype)
        return LazyTable({key: uk, agg: out}, ng)

    def _join_args(self, other, on, value, other_value):
        key_dtype = self.columns[on].dtype
        if other.columns[on].dtype != key_dtype:
            raise TypeError("join key dtypes must match on both sides")
        args = (
            core.encode_keys(other.columns[on]), other.columns[other_value],
            other.count, core.encode_keys(self.columns[on]),
            self.columns[value], self.count,
        )
        return key_dtype, args

    def join(self, other: "LazyTable", on: str, value: str,
             other_value: str) -> "LazyTable":
        key_dtype, args = self._join_args(other, on, value, other_value)
        k, bv, pv, count = join_lazy(*args)
        return LazyTable(
            {on: core.decode_keys(k, key_dtype), value: pv, other_value: bv},
            count,
        )

    def join_multi(self, other: "LazyTable", on: str, value: str,
                   other_value: str, max_matches: int = 4):
        """Inner join keeping up to max_matches build rows per key (the
        lazy counterpart of Table.join(max_matches > 1)).  Returns
        (LazyTable, truncated): `truncated` is a TRACED bool — True when a
        build key had more than max_matches rows (extra matches dropped).
        Check it at collect time; raising here would force a host sync."""
        if max_matches < 1:
            raise ValueError("max_matches must be >= 1")
        key_dtype, args = self._join_args(other, on, value, other_value)
        k, bv, pv, count, truncated = join_multi_lazy(*args, max_matches)
        return (
            LazyTable(
                {on: core.decode_keys(k, key_dtype), value: pv,
                 other_value: bv},
                count,
            ),
            truncated,
        )

    def distinct(self, key: str) -> "LazyTable":
        """SELECT DISTINCT ON (key), no host sync: one row per distinct
        valid key value — the FIRST occurrence in the original row order
        (the stable validity-aware sort guarantees it), rows ordered by
        key.  Composes the existing lazy cores: sort_by + a boundary mask
        + the validity-ANDing filter."""
        t = self.sort_by(key)
        # filter_lazy re-ANDs validity, so garbage rows past `count` cannot
        # fake a boundary
        return t.filter(core.run_starts(core.encode_keys(t.columns[key])))

    def top_k(self, key: str, k: int, largest: bool = True) -> "LazyTable":
        """ORDER BY key DESC/ASC LIMIT k, no host sync (ops/topk.py's
        stable sort and slice, then a gather of the k winning rows per
        column).  Invalid rows rank last, so they can only surface when
        count < k — and the returned count = min(count, k) masks them."""
        n = self.padded_rows
        if not 1 <= k <= n:
            raise ValueError(f"need 1 <= k <= {n}, got k={k}")
        enc = core.encode_keys(self.columns[key])
        names = list(self.columns)
        cols = top_k_lazy(
            ~enc if largest else enc,
            tuple(self.columns[m] for m in names), self.count, k,
        )
        return LazyTable(
            dict(zip(names, cols)), jnp.minimum(self.count, jnp.int32(k))
        )

    def sort_by(self, key: str, descending: bool = False) -> "LazyTable":
        names = list(self.columns)
        outs = sort_lazy(
            core.encode_keys(self.columns[key]),
            tuple(self.columns[m] for m in names), self.count, descending,
        )
        return LazyTable(dict(zip(names, outs)), self.count)

    # -- the single sync -----------------------------------------------------

    def collect(self):
        """Materialize to an eager Table — the pipeline's one host sync."""
        from radx_tpu.ops.table import Table

        c = int(self.count)
        return Table({m: v[:c] for m, v in self.columns.items()})


jax.tree_util.register_pytree_node(
    LazyTable, LazyTable.tree_flatten, LazyTable.tree_unflatten
)
