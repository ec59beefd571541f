"""Direct tests for the stable compaction helper (ops/core.compact).

Every relational op rides it (filter directly; groupby, distinct, the
joins and the dense aggregate compact their results), so it gets its own
coverage beyond the operator-level tests: densities from all-dropped to
all-kept, column counts 1-3, blocky and ragged masks, and order.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from radx_tpu.ops import core


def _run(mask, planes, c_rows=None):
    outs, count = jax.jit(core.compact)(
        jnp.asarray(mask), [jnp.asarray(p) for p in planes]
    )
    return [np.asarray(o) for o in outs], int(count)


def _check(mask, planes, c_rows=None):
    outs, count = _run(mask, planes)
    keep = mask != 0
    assert count == int(keep.sum())
    for p, o in zip(planes, outs):
        np.testing.assert_array_equal(o[:count], p[keep])
        assert not o[count:].any()  # the tail is zero


@pytest.mark.parametrize("density", [0.0, 0.03, 0.5, 0.97, 1.0])
def test_densities_single_chunk(rng, density):
    n = 32 * 128
    mask = (rng.random(n) < density).astype(np.int32)
    _check(mask, [rng.integers(0, 2**31, n).astype(np.int32)], 32)


@pytest.mark.parametrize("n_planes", [1, 2, 3])
def test_plane_counts(rng, n_planes):
    n = 16 * 128
    mask = (rng.random(n) < 0.4).astype(np.int32)
    planes = [
        rng.integers(0, 2**31, n).astype(np.int32) for _ in range(n_planes)
    ]
    _check(mask, planes, 16)


@pytest.mark.parametrize("c_rows", [8, 16, 64])
def test_chunk_heights_cover_scalar_levels(rng, c_rows):
    n = c_rows * 128
    mask = (rng.random(n) < 0.3).astype(np.int32)
    _check(mask, [np.arange(n, dtype=np.int32)], c_rows)


def test_multi_chunk_stitch(rng):
    # blocks of very different density: every block's kept rows land
    # right behind the previous block's.
    c_rows, n_chunks = 8, 4
    n = c_rows * 128 * n_chunks
    mask = np.zeros(n, np.int32)
    dens = [0.9, 0.05, 0.0, 0.6]
    for c in range(n_chunks):
        s = c * c_rows * 128
        mask[s : s + c_rows * 128] = (
            rng.random(c_rows * 128) < dens[c]
        ).astype(np.int32)
    _check(mask, [np.arange(n, dtype=np.int32)], c_rows)


def test_multi_chunk_stitch_scalar_levels_empty_first(rng):
    # the FIRST block is entirely empty, so block 1's rows start at 0.
    c_rows, n_chunks = 16, 4
    n = c_rows * 128 * n_chunks
    mask = np.zeros(n, np.int32)
    dens = [0.0, 0.7, 0.0, 0.4]
    for c in range(n_chunks):
        s = c * c_rows * 128
        mask[s : s + c_rows * 128] = (
            rng.random(c_rows * 128) < dens[c]
        ).astype(np.int32)
    _check(mask, [np.arange(n, dtype=np.int32)], c_rows)


def test_ragged_n_pads_dropped(rng):
    # n not a multiple of any block size.
    c_rows = 8
    n = c_rows * 128 * 2 + 577
    mask = (rng.random(n) < 0.5).astype(np.int32)
    _check(mask, [rng.integers(0, 2**31, n).astype(np.int32)], c_rows)


def test_stability_order_preserved(rng):
    # kept rows appear in original order: compact an iota and require the
    # prefix to be strictly increasing.
    n = 16 * 128
    mask = (rng.random(n) < 0.37).astype(np.int32)
    outs, count = _run(mask, [np.arange(n, dtype=np.int32)], 16)
    got = outs[0][:count]
    assert np.all(got[1:] > got[:-1])
    np.testing.assert_array_equal(got, np.nonzero(mask)[0])


def test_single_row_runs(rng):
    # runs of 128 rows fully kept or fully dropped.
    c_rows = 16
    n = c_rows * 128
    rows_kept = rng.random(c_rows) < 0.5
    mask = np.repeat(rows_kept, 128).astype(np.int32)
    _check(mask, [np.arange(n, dtype=np.int32)], c_rows)


@pytest.mark.parametrize(
    "dtype", [np.uint32, np.int32, np.float32, np.bool_]
)
def test_column_dtypes_and_bool_mask(rng, dtype):
    # columns keep their dtype; a boolean mask works like a 0/1 one
    n = 3000
    mask = rng.random(n) < 0.5
    col = rng.integers(0, 2, n).astype(dtype)
    _check(mask, [col])
    outs, _ = _run(mask, [col])
    assert outs[0].dtype == dtype
