"""Single-chip sort correctness vs np.sort and the stable-argsort oracle,
for host (NumPy) and device-resident inputs.

The reference never asserts correctness (SURVEY §4); these are the gates the
reference lacks: exact match, stability with duplicates, payload transport,
and adversarial distributions (BASELINE config 1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from radx_tpu.ops import sort as sort_mod

# inputs arrive as host arrays or as device-resident jax arrays
INPUTS = pytest.mark.parametrize(
    "put", [np.asarray, jnp.asarray], ids=["host", "device"]
)


def _distributions(rng, n):
    return {
        "uniform": rng.integers(0, 2**32, n, dtype=np.uint32),
        "permutation": rng.permutation(n).astype(np.uint32),
        "constant": np.full(n, 0xDEADBEEF, dtype=np.uint32),
        "presorted": np.arange(n, dtype=np.uint32),
        "reverse": np.arange(n, 0, -1).astype(np.uint32),
        "low_entropy": rng.integers(0, 16, n, dtype=np.uint32),
        "extremes": rng.choice(
            np.array([0, 1, 2**31, 2**32 - 1], dtype=np.uint32), n
        ),
    }


@INPUTS
@pytest.mark.parametrize("n", [1, 2, 100, 1000, 4096, 20000])
def test_sort_matches_npsort(rng, put, n):
    for name, keys in _distributions(rng, n).items():
        got = np.asarray(sort_mod.sort(put(keys)))
        np.testing.assert_array_equal(got, np.sort(keys), err_msg=name)


@INPUTS
def test_argsort_stable(rng, put):
    n = 20000
    keys = rng.integers(0, 64, n, dtype=np.uint32)  # heavy duplication
    got = np.asarray(sort_mod.argsort(put(keys)))
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))


@INPUTS
def test_sort_pairs_stable(rng, put):
    n = 20000
    keys = rng.integers(0, 256, n, dtype=np.uint32)
    payload = np.arange(n, dtype=np.uint32)
    k, p = sort_mod.sort_pairs(put(keys), put(payload))
    np.testing.assert_array_equal(np.asarray(k), np.sort(keys))
    np.testing.assert_array_equal(
        np.asarray(p), np.argsort(keys, kind="stable")
    )


def test_sort_pairs_float_payload(rng):
    n = 5000
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    payload = rng.normal(size=n).astype(np.float32)
    k, p = sort_mod.sort_pairs(keys, payload)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(k), keys[order])
    np.testing.assert_array_equal(np.asarray(p), payload[order])


def test_sentinel_keys_not_confused_with_padding(rng):
    # 0xFFFFFFFF is the padding of the lazy and sharded paths; real keys
    # must all survive.
    n = 3000
    keys = np.full(n, 0xFFFFFFFF, dtype=np.uint32)
    keys[:100] = rng.integers(0, 2**32, 100, dtype=np.uint32)
    got = np.asarray(sort_mod.sort(keys))
    np.testing.assert_array_equal(got, np.sort(keys))
    # stability among max-valued keys
    payload = np.arange(n, dtype=np.uint32)
    _, p = sort_mod.sort_pairs(keys, payload)
    np.testing.assert_array_equal(np.asarray(p), np.argsort(keys, kind="stable"))


def test_input_validation():
    with pytest.raises(TypeError):
        sort_mod.sort(np.arange(4, dtype=np.int64))
    with pytest.raises(ValueError):
        sort_mod.sort(np.zeros((2, 2), dtype=np.uint32))
    with pytest.raises(ValueError):
        sort_mod.sort_pairs(
            np.zeros(4, dtype=np.uint32), np.zeros(5, dtype=np.uint32)
        )


def test_vs_native_oracle(rng):
    from radx_tpu.oracle import native

    keys = rng.integers(0, 2**32, 100_000, dtype=np.uint32)
    got = np.asarray(sort_mod.sort(keys))
    np.testing.assert_array_equal(got, native.sort_u32(keys))


def test_sort_multi_planes(rng):
    from radx_tpu.ops.sort import sort_multi

    n = 4096
    keys = rng.integers(0, 64, n, dtype=np.uint32)  # many duplicates
    p1 = np.arange(n, dtype=np.int32)
    p2 = rng.normal(size=n).astype(np.float32)
    p3 = rng.integers(0, 2**32, n, dtype=np.uint32)
    k, (o1, o2, o3) = sort_multi(keys, [p1, p2, p3])
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(k), keys[order])
    np.testing.assert_array_equal(np.asarray(o1), p1[order])  # stability
    np.testing.assert_array_equal(np.asarray(o2), p2[order])
    np.testing.assert_array_equal(np.asarray(o3), p3[order])
    assert np.asarray(o2).dtype == np.float32


def test_sort_pairs_unique_keys(rng):
    n = 5000
    keys = rng.permutation(1 << 20)[:n].astype(np.uint32)
    payload = rng.integers(-(2**31), 2**31, n, dtype=np.int64).astype(np.int32)
    k, p = sort_mod.sort_pairs(keys, payload)
    order = np.argsort(keys)
    np.testing.assert_array_equal(np.asarray(k), keys[order])
    np.testing.assert_array_equal(np.asarray(p), payload[order])


def _stable_jaxpr_sorts(fn, *args):
    """The sorts in fn's jaxpr (nested jits included), as (num_keys,
    operand count, is_stable)."""
    eqns = list(jax.make_jaxpr(fn)(*args).eqns)
    found = []
    while eqns:
        e = eqns.pop()
        if e.primitive.name == "sort":
            found.append((e.params["num_keys"], len(e.invars),
                          e.params["is_stable"]))
        for v in e.params.values():
            eqns.extend(getattr(getattr(v, "jaxpr", v), "eqns", []))
    return found


@pytest.mark.parametrize("op", ["argsort", "sort_pairs", "sort_multi"])
def test_stable_sorts_emit_one_key(op):
    """Stable sorts must reach XLA as ONE sort of (key, value) with
    num_keys=1 and is_stable=True: the form XLA's GPU backend rewrites
    into CUB's radix sort (an iota tiebreak key would defeat it)."""
    k = jnp.zeros(64, jnp.uint32)
    v = jnp.zeros(64, jnp.int32)
    fn = {
        "argsort": lambda k, v: sort_mod.argsort(k),
        "sort_pairs": lambda k, v: sort_mod.sort_pairs(k, v),
        "sort_multi": lambda k, v: sort_mod.sort_multi(k, [v, v]),
    }[op]
    assert _stable_jaxpr_sorts(fn, k, v) == [(1, 2, True)]
