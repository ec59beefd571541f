"""Checks that only the card can answer (marker `gpu`; they skip on the
CPU).  Run on the card: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import radx_tpu as rx

pytestmark = pytest.mark.gpu


def _hlo(fn, *args):
    return jax.jit(fn).lower(*args).compile().as_text()


@pytest.mark.parametrize("form", ["sort", "argsort", "sort_pairs"])
def test_sorts_lower_to_cub_radix_sort(gpu, form):
    """The uint32 sort, the stable argsort and the (key, value) sort are
    rewritten by XLA into CUB's DeviceRadixSort custom call."""
    k = jax.device_put(jnp.zeros((1 << 20,), jnp.uint32), gpu)
    v = jax.device_put(jnp.zeros((1 << 20,), jnp.int32), gpu)
    fn = {
        "sort": lambda k, v: rx.sort(k),
        "argsort": lambda k, v: rx.argsort(k),
        "sort_pairs": lambda k, v: rx.sort_pairs(k, v),
    }[form]
    assert "DeviceRadixSort" in _hlo(fn, k, v)


def test_groupby_on_card_matches_numpy(gpu):
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1000, 1 << 20, dtype=np.uint32)
    vals = rng.integers(0, 2**32, 1 << 20, dtype=np.uint32)
    uk, out, ng = rx.groupby(jax.device_put(keys, gpu),
                             jax.device_put(vals, gpu), "sum")
    ng = int(ng)
    want = np.zeros(1000, np.uint64)
    np.add.at(want, keys, vals.astype(np.uint64))
    np.testing.assert_array_equal(np.asarray(uk)[:ng], np.unique(keys))
    np.testing.assert_array_equal(
        np.asarray(out)[:ng], want.astype(np.uint32)[np.unique(keys)]
    )
