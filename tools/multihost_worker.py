"""Worker process for the 2-process CPU multi-host test (config 5's
">= 2 hosts" demonstrated without a pod).

Usage (spawned by tests/test_multihost.py, one per process):
    python tools/multihost_worker.py <coordinator> <num_procs> <proc_id> <n>

Each process brings up 2 virtual CPU devices, joins the coordinator, and
runs the distributed sample-splitter sort over the global 2x2-device mesh
(collectives cross the process boundary).  Every process
regenerates the same input from a shared seed, checks its view of the
result bit-exactly against np.sort, and prints MULTIHOST_OK.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2"
    ).strip()

import numpy as np  # noqa: E402


def main():
    coordinator, num_procs, proc_id, n = (
        sys.argv[1],
        int(sys.argv[2]),
        int(sys.argv[3]),
        int(sys.argv[4]),
    )
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

    # Initialize the distributed runtime before ANY import that could touch
    # the XLA backend (jax.distributed.initialize must run first).
    from radx_tpu.parallel import multihost

    multihost.init_multihost(coordinator, num_procs, proc_id)

    import jax

    assert jax.process_count() == num_procs, jax.process_count()
    mesh = multihost.global_mesh()
    n_dev = mesh.devices.size
    assert n_dev == 2 * num_procs


    rng = np.random.default_rng(1234)  # same seed on every process
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    gkeys = multihost.shard_global(keys, mesh)

    # the guarded production entry: the exchange's collectives run under a
    # deadline + deterministic-retry (utils/guard.py) so a wedged peer is
    # detected instead of hanging every process forever
    sorted_padded, valid, overflow = multihost.sort_sharded_guarded(
        gkeys, mesh, capacity=4, timeout_s=600.0
    )
    rows = multihost.allgather_result(sorted_padded).reshape(n_dev, -1)
    counts = multihost.allgather_result(valid).reshape(-1)
    ovf = multihost.allgather_result(overflow).reshape(-1)
    assert not ovf.any(), "slot overflow"
    got = np.concatenate([rows[d, : counts[d]] for d in range(n_dev)])
    assert np.array_equal(got, np.sort(keys)), "global sort mismatch"
    print(f"MULTIHOST_OK proc={proc_id}", flush=True)


if __name__ == "__main__":
    main()
