"""Distributed sample sort on the virtual 8-device CPU mesh (SURVEY §4: the
multi-host story the reference entirely lacks).  conftest.py forces
JAX_PLATFORMS=cpu with xla_force_host_platform_device_count=8.
"""

import jax
import numpy as np
import pytest

from radx_tpu.parallel import dist_sort, make_mesh


def _run(keys, n_dev, capacity=4):
    mesh = make_mesh(n_dev)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharded = jnp.asarray(keys)
    if keys.shape[0] % n_dev == 0:
        # ragged inputs cannot be device_put with P("d"); the sort pads
        # them internally (jit reshards as needed)
        sharded = jax.device_put(sharded, NamedSharding(mesh, P("d")))
    out, valid, overflow = dist_sort.sort_sharded(
        sharded, mesh, capacity=capacity
    )
    return out, valid, np.asarray(jax.device_get(overflow))


@pytest.mark.parametrize("n_dev", [2, 8])
def test_uniform(rng, n_dev):
    keys = rng.integers(0, 2**32, 1 << 14, dtype=np.uint32)
    out, valid, overflow = _run(keys, n_dev)
    assert not overflow.any()
    got = dist_sort.collect(out, valid)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_skewed(rng):
    # 80% of keys in one narrow top-16-bit range: splitter must not send
    # everything to one device's fixed digit range.
    n = 1 << 14
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    hot = rng.integers(0x12340000, 0x1234FFFF, (n * 4) // 5, dtype=np.uint32)
    keys[: hot.size] = hot
    out, valid, overflow = _run(keys, 8, capacity=8)
    assert not overflow.any()
    got = dist_sort.collect(out, valid)
    np.testing.assert_array_equal(got, np.sort(keys))


@pytest.mark.parametrize("n_dev", [3, 6])
def test_non_pow2_devices(rng, n_dev):
    # VERDICT r3 item 6: real meshes are not always pow2; virtual sentinel
    # runs complete the merge tree.
    keys = rng.integers(0, 2**32, n_dev * (1 << 11), dtype=np.uint32)
    out, valid, overflow = _run(keys, n_dev)
    assert not overflow.any()
    got = dist_sort.collect(out, valid)
    np.testing.assert_array_equal(got, np.sort(keys))


@pytest.mark.parametrize("n_dev", [6, 8])
def test_ragged_n(rng, n_dev):
    # n % D != 0: wrapper pads to D*ceil(n/D); pads must not leak into the
    # output or the valid counts.
    keys = rng.integers(0, 2**32, (1 << 14) - 777, dtype=np.uint32)
    out, valid, overflow = _run(keys, n_dev)
    assert not overflow.any()
    assert int(np.asarray(jax.device_get(valid)).sum()) == keys.shape[0]
    got = dist_sort.collect(out, valid)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_ragged_pairs_with_sentinel_keys(rng):
    # ragged + real 0xFFFFFFFF keys: pads share the real max key; the
    # global-index column must keep every real payload, in order.
    import jax.numpy as jnp

    n = (1 << 13) - 123
    keys = rng.integers(0, 1000, n, dtype=np.uint32)
    keys[::5] = 0xFFFFFFFF
    vals = rng.integers(0, 2**31, n, dtype=np.uint32)
    mesh = make_mesh(8)
    k, v, valid, overflow = dist_sort.sort_pairs_sharded(
        jnp.asarray(keys), jnp.asarray(vals), mesh
    )
    assert not np.asarray(jax.device_get(overflow)).any()
    gk = dist_sort.collect(k, valid)
    gv = dist_sort.collect(v, valid)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, vals[order])


def test_skewed_large_per_device(rng):
    # VERDICT r3 item 6: skewed input at scale on the 8-device mesh.
    # 2^17/device here (CPU wall-time bound); the card-scale
    # version runs in `chip_smoke.py --chips 4`.
    n = 1 << 20
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    hot = rng.integers(0x77000000, 0x77000400, (n * 3) // 4, dtype=np.uint32)
    keys[: hot.size] = hot
    out, valid, overflow = _run(keys, 8, capacity=8)
    assert not overflow.any()
    got = dist_sort.collect(out, valid)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_constant_overflows_gracefully(rng):
    # all keys identical: one device must receive everything; with small
    # capacity the overflow flag must trip rather than silently corrupt.
    keys = np.full(1 << 13, 0xABCD1234, dtype=np.uint32)
    out, valid, overflow = _run(keys, 8, capacity=1)
    assert overflow.any()
    # and with enough capacity it must succeed
    out, valid, overflow = _run(keys, 8, capacity=8)
    assert not overflow.any()
    got = dist_sort.collect(out, valid)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_sentinel_keys(rng):
    keys = rng.integers(0, 2**32, 1 << 13, dtype=np.uint32)
    keys[:1000] = 0xFFFFFFFF
    out, valid, overflow = _run(keys, 4)
    assert not overflow.any()
    got = dist_sort.collect(out, valid)
    np.testing.assert_array_equal(got, np.sort(keys))


def _shard(arr, mesh):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    return jax.device_put(jnp.asarray(arr), NamedSharding(mesh, P("d")))


@pytest.mark.parametrize("exchange", ["flat", "hier"])
def test_pairs_payload_follows_keys(rng, exchange):
    n = 1 << 13
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    vals = rng.standard_normal(n).astype(np.float32)
    mesh = make_mesh(4)
    k, v, valid, overflow = dist_sort.sort_pairs_sharded(
        _shard(keys, mesh), _shard(vals, mesh), mesh,
        exchange=exchange,
    )
    assert not np.asarray(jax.device_get(overflow)).any()
    gk = dist_sort.collect(k, valid)
    gv = dist_sort.collect(v, valid)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, vals[order])


def test_pairs_stable_duplicates(rng):
    # many duplicate keys across shard boundaries: pair sorts keep the
    # original global order of equal keys.
    n = 1 << 13
    keys = rng.integers(0, 16, n, dtype=np.uint32) << 28
    vals = np.arange(n, dtype=np.uint32)
    mesh = make_mesh(8)
    k, v, valid, overflow = dist_sort.sort_pairs_sharded(
        _shard(keys, mesh), _shard(vals, mesh), mesh, capacity=8,
    )
    assert not np.asarray(jax.device_get(overflow)).any()
    gk = dist_sort.collect(k, valid)
    gv = dist_sort.collect(v, valid)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, vals[order])


def test_pairs_sentinel_keys_keep_payloads(rng):
    # keys equal to 0xFFFFFFFF tie with the pad sentinel; their payloads
    # must still land inside the valid prefix.
    n = 1 << 12
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    keys[: n // 4] = 0xFFFFFFFF
    vals = np.arange(n, dtype=np.int32)
    mesh = make_mesh(4)
    k, v, valid, overflow = dist_sort.sort_pairs_sharded(
        _shard(keys, mesh), _shard(vals, mesh), mesh, capacity=8,
    )
    assert not np.asarray(jax.device_get(overflow)).any()
    gk = dist_sort.collect(k, valid)
    gv = dist_sort.collect(v, valid)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, vals[order].astype(np.int32))


def test_argsort_global_indices(rng):
    n = 1 << 13
    keys = rng.integers(0, 256, n, dtype=np.uint32)  # heavy duplicates
    mesh = make_mesh(8)
    k, idx, valid, overflow = dist_sort.argsort_sharded(
        _shard(keys, mesh), mesh, capacity=8
    )
    assert not np.asarray(jax.device_get(overflow)).any()
    gk = dist_sort.collect(k, valid)
    gi = dist_sort.collect(idx, valid)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gi, order.astype(np.int32))
    np.testing.assert_array_equal(gk, keys[order])


def test_rejects_non_u32():
    mesh = make_mesh(2)
    keys = np.arange(1 << 10, dtype=np.int32)
    with pytest.raises(TypeError):
        dist_sort.sort_sharded(_shard(keys, mesh), mesh)


def test_shard_body_hlo_has_no_scatter_gather(rng):
    """The keys-only distributed sort moves keys with sorts, contiguous
    slices and collectives only: its HLO has no per-key gather or scatter
    (each would be a random-access pass over the shard)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(8)
    keys = jax.device_put(
        jnp.asarray(rng.integers(0, 2**32, 8 * 1024, dtype=np.uint32)),
        NamedSharding(mesh, P("d")),
    )
    lowered = jax.jit(
        lambda k: dist_sort.sort_sharded(k, mesh)
    ).lower(keys)
    hlo = lowered.compiler_ir(dialect="hlo").as_hlo_text()

    import re

    def result_elems(line):
        m_ = re.search(r"=\s+\w+\[([\d,]*)\]", line)
        if not m_ or not m_.group(1):
            return 1
        out = 1
        for d in m_.group(1).split(","):
            out *= int(d)
        return out

    # splitter sampling reads OVERSAMPLE·D elements per shard — the only
    # sanctioned gather budget; anything bigger is per-key
    budget = dist_sort.OVERSAMPLE * 8
    bad = []
    for ln in hlo.splitlines():
        s = ln.strip()
        if "all_gather" in s:
            continue
        if " gather(" in s and result_elems(s) > budget:
            bad.append(s)
        if " scatter(" in s and not (
            "indices_are_sorted=true" in s and "unique_indices=true" in s
        ):
            # sorted-unique scatters are pad/concat copies; real binning
            # scatters (.at[idx].add over digit bins) never qualify
            bad.append(s)
    assert not bad, "pathological ops in HLO:\n" + "\n".join(bad[:10])


# --- hierarchical two-phase exchange (VERDICT r4 #8) -------------------------


@pytest.mark.parametrize("n_dev", [4, 8])
def test_hier_exchange_matches_flat(rng, n_dev):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    keys = rng.integers(0, 2**32, 1 << 14, dtype=np.uint32)
    mesh = make_mesh(n_dev)
    sharded = jax.device_put(
        jnp.asarray(keys), NamedSharding(mesh, P("d"))
    )
    out, valid, overflow = dist_sort.sort_sharded(
        sharded, mesh, capacity=4, exchange="hier"
    )
    assert not np.asarray(jax.device_get(overflow)).any()
    got = dist_sort.collect(out, valid)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_hier_exchange_skewed(rng):
    n = 1 << 14
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    hot = rng.integers(0x99990000, 0x9999FFFF, (n * 4) // 5, dtype=np.uint32)
    keys[: hot.size] = hot
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = make_mesh(8)
    sharded = jax.device_put(jnp.asarray(keys), NamedSharding(mesh, P("d")))
    out, valid, overflow = dist_sort.sort_sharded(
        sharded, mesh, capacity=8, exchange="hier"
    )
    assert not np.asarray(jax.device_get(overflow)).any()
    got = dist_sort.collect(out, valid)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_hier_pairs_stable(rng):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = 1 << 13
    keys = (rng.integers(0, 64, n)).astype(np.uint32)  # heavy duplicates
    vals = np.arange(n, dtype=np.uint32)
    mesh = make_mesh(4)
    kj = jax.device_put(jnp.asarray(keys), NamedSharding(mesh, P("d")))
    vj = jax.device_put(jnp.asarray(vals), NamedSharding(mesh, P("d")))
    ks, vs, valid, ovf = dist_sort.sort_pairs_sharded(
        kj, vj, mesh, capacity=8, exchange="hier"
    )
    assert not np.asarray(jax.device_get(ovf)).any()
    got_k = dist_sort.collect(ks, valid)
    got_v = dist_sort.collect(vs, valid)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(got_k, keys[order])
    np.testing.assert_array_equal(got_v, order.astype(np.uint32))


def test_hier_non_pow2_falls_back_to_flat(rng):
    # D=6 is not pow2: exchange="hier" must silently use the flat path
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    keys = rng.integers(0, 2**32, 6 * (1 << 10), dtype=np.uint32)
    mesh = make_mesh(6)
    sharded = jax.device_put(jnp.asarray(keys), NamedSharding(mesh, P("d")))
    out, valid, overflow = dist_sort.sort_sharded(
        sharded, mesh, capacity=4, exchange="hier"
    )
    assert not np.asarray(jax.device_get(overflow)).any()
    got = dist_sort.collect(out, valid)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_auto_capacity_escalation(rng):
    # Globally presorted input is the adversarial case for per-(src,dst)
    # slots: source shard s holds exactly splitter range s, so the (s,s)
    # pair receives a full shard — ~D/2× the default slot.  The auto
    # wrapper must escalate until exact, and report the capacity it used.
    n_dev = 4
    n = n_dev * (1 << 11)
    keys = np.sort(rng.integers(0, 2**32, n, dtype=np.uint32))
    mesh = make_mesh(n_dev)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharded = jax.device_put(
        jnp.asarray(keys), NamedSharding(mesh, P("d"))
    )
    out, valid, cap = dist_sort.sort_sharded_auto(sharded, mesh)
    assert cap > 2  # the tight default must not have been enough
    got = dist_sort.collect(out, valid)
    np.testing.assert_array_equal(got, keys)


def test_auto_capacity_uniform_stays_tight(rng):
    # Uniform data must succeed at the memory-tight capacity=1 (no
    # escalation): the recv buffer stays ~2-4x the shard.
    n_dev = 4
    keys = rng.integers(0, 2**32, n_dev * (1 << 11), dtype=np.uint32)
    mesh = make_mesh(n_dev)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    sharded = jax.device_put(
        jnp.asarray(keys), NamedSharding(mesh, P("d"))
    )
    out, valid, cap = dist_sort.sort_sharded_auto(sharded, mesh)
    assert cap == 2
    got = dist_sort.collect(out, valid)
    np.testing.assert_array_equal(got, np.sort(keys))


def test_auto_capacity_pairs(rng):
    # the pairs variant escalates the same way and keeps payloads attached
    n_dev = 4
    n = n_dev * (1 << 11)
    keys = np.sort(rng.integers(0, 2**32, n, dtype=np.uint32))  # worst case
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    mesh = make_mesh(n_dev)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    sk = jax.device_put(jnp.asarray(keys), NamedSharding(mesh, P("d")))
    sv = jax.device_put(jnp.asarray(vals), NamedSharding(mesh, P("d")))
    k, v, valid, cap = dist_sort.sort_pairs_sharded_auto(
        sk, sv, mesh
    )
    assert cap > 2
    gk = dist_sort.collect(k, valid)
    gv = dist_sort.collect(v, valid)
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(gk, keys[order])
    np.testing.assert_array_equal(gv, vals[order])
