"""Filter (predicate → compaction) — BASELINE config 3's first half.

Compaction is a *stable partition*, i.e. a 1-bit radix pass — the degenerate
case of the reference's per-digit rank-and-scatter
(RadX2-SM7-DEV/scattering.comp:125-127): a prefix sum of the mask ranks the
kept rows, and one scatter per column moves them (ops/core.compact).  The
reference has no relational layer at all; this is the "filter" operator
demanded by BASELINE.json.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from radx_tpu.ops import core


@jax.jit
def _compact_jit(mask, cols):
    return core.compact(mask, list(cols))


def filter_columns(mask, cols):
    """Stable compaction of 32-bit columns by a boolean/0-1 mask.

    Returns (cols_out, count): each column reordered so rows where mask!=0
    occupy the first `count` slots in original order; the tail is zero.
    """
    mask = jnp.asarray(mask)
    cols = [jnp.asarray(c) for c in cols]
    n = mask.shape[0]
    for c in cols:
        if c.shape != (n,):
            raise ValueError("all columns must match mask shape")
        if c.dtype.itemsize != 4:
            raise TypeError("columns must be 32-bit dtypes")
    if n == 0:
        return cols, jnp.int32(0)
    if n >= 1 << 31:
        raise ValueError("filter supports fewer than 2^31 rows per call")
    return _compact_jit(mask, tuple(cols))
