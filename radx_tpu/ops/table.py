"""Columnar Table: the query-executor surface over the sort/filter/groupby/
join primitives (the reference is a bare sort library; BASELINE.json frames
this engine as a vectorized query executor, so the operator graph gets a
first-class batch-columnar API).

A Table is an immutable set of named, equal-length 32-bit columns.  All
operators return new Tables; padding/validity is handled internally so the
user-facing rows are always exactly the valid ones.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import jax
import jax.numpy as jnp
import numpy as np

from radx_tpu.ops import core
from radx_tpu.ops import filter as filter_ops
from radx_tpu.ops import groupby as groupby_ops
from radx_tpu.ops import join as join_ops
from radx_tpu.ops import sort as sort_ops


@dataclasses.dataclass(frozen=True)
class Table:
    columns: Mapping[str, jax.Array]

    def __post_init__(self):
        if not self.columns:
            raise ValueError("table needs at least one column")
        lens = {c.shape[0] for c in self.columns.values()}
        if len(lens) != 1:
            raise ValueError("all columns must have equal length")
        for name, c in self.columns.items():
            if c.ndim != 1 or c.dtype.itemsize != 4:
                raise TypeError(f"column {name!r} must be 1-D 32-bit")

    @classmethod
    def from_arrays(cls, **cols) -> "Table":
        return cls({k: jnp.asarray(v) for k, v in cols.items()})

    @property
    def num_rows(self) -> int:
        return next(iter(self.columns.values())).shape[0]

    def column(self, name: str):
        return self.columns[name]

    def to_numpy(self) -> dict[str, np.ndarray]:
        return {k: np.asarray(jax.device_get(v)) for k, v in self.columns.items()}

    def lazy(self):
        """Switch to the no-host-sync pipeline API (ops/lazy.LazyTable):
        operators thread a traced row count instead of slicing via
        ``int(count)``, so filter→groupby→join→sort fuses under one jit;
        ``collect()`` is the single sync at the end."""
        from radx_tpu.ops.lazy import LazyTable

        return LazyTable.from_table(self)

    # -- operators ---------------------------------------------------------

    def sort_by(self, key, descending=False) -> "Table":
        """Stable sort of all columns by one — or several —
        uint32/int32/float32 columns.

        `key` may be a column name or a list of names (primary first);
        `descending` a bool or a per-key list.  Multi-column order is an
        LSD composition of stable single-column passes (least-significant
        key first) — the same stability argument as the reference's
        per-digit pipeline (radx_implement.inl:421-447), lifted from
        digits to whole columns."""
        keys = [key] if isinstance(key, str) else list(key)
        descs = (
            [descending] * len(keys)
            if isinstance(descending, bool)
            else list(descending)
        )
        if len(descs) != len(keys):
            raise ValueError("descending list must match key list")
        t = self
        for k, d in zip(reversed(keys), reversed(descs)):
            t = t._sort_by_one(k, d)
        return t

    def _sort_by_one(self, key: str, descending: bool) -> "Table":
        enc = core.encode_keys(self.columns[key])
        if descending:
            enc = ~enc
        names = list(self.columns)
        _, outs = sort_ops.sort_multi(enc, [self.columns[n] for n in names])
        return Table(dict(zip(names, outs)))

    def filter(self, mask) -> "Table":
        """Keep rows where mask != 0 (stable)."""
        names = list(self.columns)
        cols, count = filter_ops.filter_columns(
            mask, [self.columns[n] for n in names]
        )
        count = int(count)
        return Table({n: c[:count] for n, c in zip(names, cols)})

    def distinct(self, key: str) -> "Table":
        """SELECT DISTINCT ON (key): one row per distinct key value, the
        FIRST occurrence in the original row order (stable), rows ordered
        by key.  Built from the stable sort + the boundary compaction."""
        names = list(self.columns)
        enc = core.encode_keys(self.columns[key])
        ks, outs = sort_ops.sort_multi(enc, [self.columns[n] for n in names])
        cols, count = filter_ops.filter_columns(core.run_starts(ks), outs)
        count = int(count)
        return Table({n: c[:count] for n, c in zip(names, cols)})

    def top_k(self, key: str, k: int, largest: bool = True) -> "Table":
        """ORDER BY key DESC/ASC LIMIT k over all columns (ties keep the
        earliest original rows) via the selection operator (ops/topk.py)
        and one gather of k rows per column."""
        from radx_tpu.ops.topk import top_k as _top_k

        _, idx = _top_k(self.columns[key], k, largest)
        return Table({n: c[idx] for n, c in self.columns.items()})

    def groupby(self, key: str, value: str, agg: str = "sum",
                bins: int | None = None) -> "Table":
        """GROUP BY key aggregating value; returns Table(key, agg).

        Pass `bins` (a bound on the key space; keys must be bin ids in
        [0, bins)) to route through the dense aggregate, which needs no
        sort.
        """
        if bins is not None:
            uk, out, ng = groupby_ops.groupby_dense(
                self.columns[key], self.columns[value], agg, bins
            )
        else:
            uk, out, ng = groupby_ops.groupby(
                self.columns[key], self.columns[value], agg
            )
        ng = int(ng)
        return Table({key: uk[:ng], agg: out[:ng]})

    def join(self, other: "Table", on: str, value: str, other_value: str,
             max_matches: int = 1, how: str = "inner",
             missing=None) -> "Table":
        """Inner or left join with `other` on column `on` (build side).

        max_matches == 1 (default): one match per row (duplicate build keys
        resolve to the last build row); larger values keep up to
        max_matches build rows per row.  how="left" (max_matches == 1 only)
        keeps every row of THIS table, with `missing` (default 0) as
        other_value where no key matched.
        """
        if how != "inner" and max_matches != 1:
            raise ValueError("how='left' requires max_matches == 1")
        if max_matches == 1:
            k, bv, pv, count = join_ops.join_merge(
                other.columns[on], other.columns[other_value],
                self.columns[on], self.columns[value],
                how=how, missing=missing,
            )
        else:
            k, bv, pv, valid, truncated = join_ops.join_merge_multi(
                other.columns[on], other.columns[other_value],
                self.columns[on], self.columns[value],
                max_matches=max_matches,
            )
            if bool(truncated):
                raise ValueError(
                    "join truncated: a build key exceeded max_matches; "
                    f"re-run with max_matches > {max_matches}"
                )
            k, bv, pv, count = join_ops.expand_matches(k, bv, pv, valid)
        count = int(count)
        return Table({on: k[:count], value: pv[:count],
                      other_value: bv[:count]})
