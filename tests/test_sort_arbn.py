"""Arbitrary-N sorts: no length is special.

The reference handles any N natively via validity ballots
(RadX2-SM7-DEV/includes.glsl:171-182); here every public sort takes any
length as it stands — no padding to a power of two, no sentinel keys.
These cases sit just past, just below and between powers of two, and at
sizes where a padded sort would have wasted most of its work.
"""

import numpy as np
import pytest

from radx_tpu.ops import sort as S

SIZES = [
    1025, 3000, 3 * 1024 + 17, 7 * 1024 - 1, 11111, 5 * 8 * 128,
    (1 << 16) + 1, 3 * (1 << 18) + 7, (1 << 20) - 3,
]


@pytest.mark.parametrize("n", SIZES)
def test_sort_arbn_keys(rng, n):
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    np.testing.assert_array_equal(np.asarray(S.sort(keys)), np.sort(keys))


@pytest.mark.parametrize("n", [5 * 64 * 128 + 13, (1 << 22) + 1])
def test_sort_arbn_argsort_sizes(rng, n):
    keys = rng.integers(0, 1000, n, dtype=np.uint32)
    np.testing.assert_array_equal(
        np.asarray(S.argsort(keys)), np.argsort(keys, kind="stable")
    )


def test_sort_arbn_stable_pairs(rng):
    n = 3 * 1024 + 300
    keys = rng.integers(0, 50, n).astype(np.uint32)  # many duplicates
    payload = np.arange(n, dtype=np.uint32)
    k, p = S.sort_pairs(keys, payload)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(k), keys[order])
    np.testing.assert_array_equal(np.asarray(p), payload[order])


def test_sort_arbn_argsort(rng):
    n = 5 * 1024 + 1
    keys = rng.integers(0, 100, n).astype(np.uint32)
    np.testing.assert_array_equal(
        np.asarray(S.argsort(keys)), np.argsort(keys, kind="stable")
    )


def test_sort_arbn_extremes(rng):
    """Only 0 and 0xFFFFFFFF keys at a non-pow2 size."""
    n = 2048 + 128
    keys = np.where(
        rng.random(n) < 0.3, np.uint32(0xFFFFFFFF), np.uint32(0)
    ).astype(np.uint32)
    np.testing.assert_array_equal(np.asarray(S.sort(keys)), np.sort(keys))
