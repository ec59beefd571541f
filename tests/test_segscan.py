"""Segmented scans and the forward fill over sorted runs (ops/core:
run_starts, run_ends, run_scan, run_aggregate, fill_source) vs a scalar
reference.

Covers runs of every length (one key, few keys, thousands), all ops, float
arithmetic, the join's "fill", and the traced valid-row count.
"""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from radx_tpu.ops import core


def _ref_scan(k, v, op):
    out = np.empty_like(v)
    tot = None
    fn = {"sum": lambda a, b: a + b, "min": min, "max": max}[op]
    for i in range(len(k)):
        tot = v[i] if (i == 0 or k[i] != k[i - 1]) else fn(tot, v[i])
        out[i] = tot
    return out


def _run_totals(k, scan):
    """Per-run final values of an inclusive segmented scan."""
    last = np.append(k[1:] != k[:-1], True)
    return scan[last]


@functools.partial(jax.jit, static_argnames=("agg",))
def _reduce(k, v, count, agg):
    """Per-run aggregates, read at the run ends and compacted."""
    first = core.run_starts(k, count)
    acc = core.run_aggregate(v, first, agg)
    (out,), ng = core.compact(core.run_ends(first, count), [acc])
    return out, ng


@pytest.mark.parametrize("rows,nkeys", [(8, 3), (32, 5), (64, 1), (64, 2000)])
@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_segscan_ops_cross_chunk(rng, rows, nkeys, op):
    n = rows * 128
    k = np.sort(rng.integers(0, nkeys, n).astype(np.uint32))
    v = rng.integers(0, 100, n).astype(np.uint32)
    scan = jax.jit(core.run_scan, static_argnames="op")(
        jnp.asarray(v), core.run_starts(jnp.asarray(k)), op
    )
    np.testing.assert_array_equal(np.asarray(scan), _ref_scan(k, v, op))
    out, ng = _reduce(jnp.asarray(k), jnp.asarray(v), None, op)
    want = _run_totals(k, _ref_scan(k, v, op))
    assert int(ng) == want.size
    np.testing.assert_array_equal(np.asarray(out)[: want.size], want)


def test_segscan_float32(rng):
    n = 32 * 128
    k = np.sort(rng.integers(0, 17, n).astype(np.uint32))
    v = rng.normal(size=n).astype(np.float32)
    out, ng = _reduce(jnp.asarray(k), jnp.asarray(v), None, "sum")
    want = _run_totals(k, _ref_scan(k, v.astype(np.float64), "sum"))
    # float32 sums in tree order vs float64 sequential sums
    np.testing.assert_allclose(
        np.asarray(out)[: int(ng)], want.astype(np.float32), rtol=1e-4,
        atol=1e-3,
    )


def test_segscan_fill(rng):
    """The join's fill: each row finds the last flagged row at or before it
    within its run."""
    n = 32 * 128
    k = np.sort(rng.integers(0, 9, n).astype(np.uint32))
    hv = rng.random(n) < 0.1
    src = np.asarray(
        jax.jit(core.fill_source)(jnp.asarray(hv), core.run_starts(jnp.asarray(k)))
    )
    want = np.full(n, -1)
    last, lastk = -1, None
    for i in range(n):
        if lastk is None or k[i] != lastk:
            last, lastk = -1, k[i]
        if hv[i]:
            last = i
        want[i] = last
    np.testing.assert_array_equal(src, want)


def test_segscan_flat_padding(rng):
    """Rows at or past the traced count belong to no group, even when their
    keys equal the last valid key (0xFFFFFFFF, the lazy paths' padding)."""
    n, count = 1000, 980
    k = np.sort(rng.integers(0, 7, n).astype(np.uint32))
    k[-40:] = 0xFFFFFFFF  # valid and invalid rows share the max key
    v = rng.integers(0, 50, n).astype(np.uint32)
    out, ng = _reduce(jnp.asarray(k), jnp.asarray(v), jnp.int32(count), "sum")
    want = _run_totals(k[:count], _ref_scan(k[:count], v[:count], "sum"))
    assert int(ng) == want.size
    np.testing.assert_array_equal(np.asarray(out)[: want.size], want)
