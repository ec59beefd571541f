"""top_k — k largest (or smallest) keys with their original indices.

Query-executor surface (ORDER BY ... LIMIT k): the reference library has no
selection operator (it is a bare sort, SURVEY §2), but any user of a sort
library reaches for top-k next.

Selection is a stable sort of the order-encoded keys followed by a slice of
the first k rows: ties resolve by smallest original index, the same
(value, index) lexicographic order as jax.lax.top_k.

Key dtypes: uint32 / int32 / float32 via the order-preserving encodings of
ops/core.py (float total order: -inf < ... < -0.0 < +0.0 < ... < +inf <
nan, so with largest=True NaNs rank first, matching lax.top_k).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from radx_tpu.ops import core


def top_k_core(work, k: int):
    """work: uint32 keys encoded so that ASCENDING order is the requested
    output order.  Returns (work_sorted[:k], indices[:k])."""
    sk, perm = core.argsort_stable(work)
    return sk[:k], perm[:k]


@functools.partial(jax.jit, static_argnames=("k", "largest"))
def _top_k_jit(enc, k: int, largest: bool):
    wk, idx = top_k_core(~enc if largest else enc, k)
    return (~wk if largest else wk), idx


def top_k(keys, k: int, largest: bool = True):
    """The k largest (default) or smallest keys, with original indices.

    Returns (values, indices): values in descending order when
    largest=True (ascending otherwise); ties keep the smallest original
    index first — the exact (value, index) lexicographic order, matching
    jax.lax.top_k / np.argsort(kind="stable") semantics.

    keys: 1-D uint32 / int32 / float32.  Requires 1 <= k <= len(keys).
    """
    keys = jnp.asarray(keys)
    enc = core.encode_keys(keys)
    n = keys.shape[0]
    if not 1 <= k <= n:
        raise ValueError(f"need 1 <= k <= {n}, got k={k}")
    wk, idx = _top_k_jit(enc, k, largest)
    return core.decode_keys(wk, keys.dtype), idx
