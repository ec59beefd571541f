"""Failure detection around device work — SURVEY §5's failure-detection gap.

The reference has no failure handling at all: VkResult codes are ignored
(Radix::command unconditionally returns VK_SUCCESS,
radx_implement.inl:446) and fence waits block forever (INT64_MAX,
radx_utils.hpp:201-244).  Multi-host collectives make that untenable: a
peer that dies mid-`all_to_all` leaves every other process blocked
indefinitely.  XLA cannot abort an in-flight executable, so the honest
contract is detect-and-relaunch:

  * `watchdog` — dispatch the jitted step, wait for completion on a worker
    thread, and raise `DeviceTimeout` if the deadline passes (the stuck
    buffers stay on device; the caller tears the process down or re-inits
    the distributed runtime — sort is stateless, so relaunching from the
    host inputs is exact recovery).
  * `retry_deterministic` — run a stateless step, re-dispatching up to
    `retries` times on transient runtime failures.  Every operator in this
    engine is a pure function of its inputs, so a retry is bit-identical
    (the deterministic re-launch story SURVEY §5 asks for).
"""

from __future__ import annotations

import threading
import time

import jax


class DeviceTimeout(RuntimeError):
    """A device step (usually a collective) missed its deadline."""


def watchdog(fn, *args, timeout_s: float = 120.0):
    """Run `fn(*args)` and block until its outputs are ready, raising
    `DeviceTimeout` after `timeout_s` seconds.

    Dispatch AND completion-wait both run on a daemon thread (some backends
    execute host callbacks synchronously at dispatch, so dispatching on the
    caller thread could itself hang past the deadline).  The caller regains
    control even though XLA offers no cancellation; on timeout the result
    buffers are abandoned (the thread keeps waiting harmlessly) and the
    caller should re-initialize the runtime before reusing the mesh.
    """
    done = threading.Event()
    err: list[BaseException] = []
    res: list = []

    def work():
        try:
            out = fn(*args)
            jax.block_until_ready(out)
            res.append(out)
        except BaseException as e:  # surfaced to the caller below
            err.append(e)
        finally:
            done.set()

    t = threading.Thread(target=work, daemon=True)
    t.start()
    if not done.wait(timeout_s):
        raise DeviceTimeout(
            f"device step exceeded {timeout_s:.1f}s deadline — a peer or "
            "collective is likely hung; relaunch from host inputs"
        )
    if err:
        raise err[0]
    return res[0]


def retry_deterministic(fn, *args, retries: int = 2, timeout_s: float = 120.0,
                        on_retry=None):
    """Run a stateless step under the watchdog, re-dispatching up to
    `retries` extra times on timeout or transient XLA runtime errors.
    Inputs live on the host or are regenerated by `fn` itself, so every
    attempt computes the identical result (pure function).

    `on_retry(attempt, exc)` runs before each re-dispatch — for a
    DeviceTimeout caused by a HUNG collective it MUST re-initialize the
    runtime (tear down / re-create the jax.distributed client or process),
    because XLA cannot abort the stuck executable and a bare retry would
    enqueue behind it and burn the remaining budget.  Without an `on_retry`
    that resets the runtime, this helper is only sound for transient
    dispatch errors (preempted RPC, allocator hiccup), not hung devices.
    """
    attempt = 0
    while True:
        try:
            return watchdog(fn, *args, timeout_s=timeout_s)
        except (DeviceTimeout, jax.errors.JaxRuntimeError) as e:
            attempt += 1
            if attempt > retries:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            time.sleep(min(0.1 * attempt, 1.0))
