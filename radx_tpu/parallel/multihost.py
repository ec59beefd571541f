"""Multi-host bring-up — BASELINE config 5's ">= 2 hosts" entry point.

The reference is strictly single-device (SURVEY §2e: no comm code at all);
this module is the net-new host-framework glue: `jax.distributed.initialize`
wiring so every process sees the global device set, a global mesh
constructor, and result-collection helpers.  The same `parallel.dist_sort`
shard_map code then runs unchanged across hosts — collectives ride whatever
transport the mesh spans, which is the whole point of expressing the
exchange as `ppermute`/`all_gather` instead of hand-rolled NCCL (the
scaling-book recipe: pick a mesh, annotate shardings, let XLA place the
collectives).

Tested without a pod via JAX's multi-process CPU backend: two OS processes
x N virtual CPU devices each, coordinator over localhost — see
tests/test_multihost.py / tools/multihost_worker.py.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def init_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids: list[int] | None = None,
):
    """Connect this process to the job's coordinator.

    Call once per process before any other JAX API.  The explicit form
    serves GPU clusters and the multi-process CPU test rig alike.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
    )


def global_mesh(axis: str = "d") -> Mesh:
    """1-D mesh over every device of every connected process."""
    return Mesh(np.asarray(jax.devices()), (axis,))


def shard_global(host_array, mesh: Mesh, axis: str = "d"):
    """Build a globally-sharded jax.Array from an identical host copy.

    Every process passes the same full `host_array` (e.g. regenerated from
    a shared seed, or read from shared storage); each device materializes
    only its own shard — the standard way to feed a multi-host run without
    shipping the whole array anywhere.
    """
    sharding = NamedSharding(mesh, P(axis))
    return jax.make_array_from_callback(
        host_array.shape, sharding, lambda idx: host_array[idx]
    )


def allgather_result(x):
    """Fetch a sharded result to every host as numpy (tiny results only)."""
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def _collective_timeout_s(n_keys: int, n_devices: int) -> float:
    """Deadline for one distributed sort step: a generous multiple of the
    worst-case rate (0.1 G keys/s covers CPU test meshes and cold caches)
    plus a fixed floor for bring-up and network latency."""
    per_device = max(n_keys // max(n_devices, 1), 1)
    return 60.0 + per_device / 0.1e9 * 20.0


def sort_sharded_guarded(
    keys,
    mesh: Mesh,
    *,
    capacity: float | None = None,
    timeout_s: float | None = None,
    retries: int = 2,
    on_retry=None,
):
    """`dist_sort.sort_sharded` under the failure-detection guard — the
    production multi-host entry (SURVEY §5 failure detection; the
    anti-pattern being replaced is the reference's ignored VkResult,
    radx_implement.inl:446).

    The exchange's ppermute waves block on every peer; a dead or wedged
    peer turns the step into an indefinite hang (XLA offers no abort), so
    the step runs under `utils.guard.retry_deterministic`: a deadline
    sized to the workload, then up to `retries` re-dispatches.  The sort
    is a pure function of `keys`, so a retry is bit-identical recovery.
    `on_retry(attempt, exc)` must re-initialize the distributed runtime
    when the failure was a DeviceTimeout (see guard.retry_deterministic).
    """
    from radx_tpu.parallel import dist_sort
    from radx_tpu.utils import guard

    if timeout_s is None:
        timeout_s = _collective_timeout_s(keys.shape[0], mesh.devices.size)

    def step():
        if capacity is None:
            return dist_sort.sort_sharded(keys, mesh)
        return dist_sort.sort_sharded(keys, mesh, capacity=capacity)

    return guard.retry_deterministic(
        step, retries=retries, timeout_s=timeout_s, on_retry=on_retry
    )
