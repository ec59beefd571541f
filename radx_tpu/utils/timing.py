"""Timing / metrics harness — the analogue of the reference's GPU timestamp
bracketing (vkCmdWriteTimestamp around the sort region, src/test/sort.cpp:
388-450) plus its missing structured metrics (SURVEY §5: the reference
prints raw ms to stdout and reads no counters).

`time_op` times each call of a jitted function up to `block_until_ready`
on the host clock and reports the median and the spread of the repeats.
"""

from __future__ import annotations

import dataclasses
import statistics
import time
from typing import Callable

import jax


@dataclasses.dataclass
class Metrics:
    """Structured per-op metrics (SURVEY §5 'metrics/logging' gap)."""

    name: str
    seconds: float  # median of the timed calls
    items: int
    bytes_moved: int = 0
    spread_pct: float = 0.0  # (max - min) / median of the timed calls

    @property
    def items_per_s(self) -> float:
        return self.items / self.seconds if self.seconds > 0 else float("inf")

    @property
    def gbytes_per_s(self) -> float:
        return self.bytes_moved / self.seconds / 1e9 if self.seconds > 0 else 0.0

    def row(self) -> str:
        return (
            f"{self.name:32s} {self.seconds*1e3:9.3f} ms  "
            f"{self.items_per_s/1e9:8.3f} G items/s  "
            f"{self.gbytes_per_s:8.1f} GB/s  ±{self.spread_pct:.1f}%"
        )


def time_calls(fn: Callable, *args, repeats: int = 9) -> list[float]:
    """Seconds of each of `repeats` calls of fn(*args), each ended by
    block_until_ready, after one untimed warm-up call (compilation)."""
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times


def time_op(
    fn: Callable,
    x,
    *,
    name: str = "op",
    items: int | None = None,
    bytes_moved: int = 0,
    repeats: int = 9,
) -> Metrics:
    """Measure jit(fn)(x): the median of `repeats` timed calls."""
    times = time_calls(jax.jit(fn), x, repeats=repeats)
    med = statistics.median(times)
    n = items if items is not None else jax.tree.leaves(x)[0].size
    return Metrics(
        name=name, seconds=med, items=n, bytes_moved=bytes_moved,
        spread_pct=100.0 * (max(times) - min(times)) / med,
    )


def trace(path: str):
    """Context manager: capture a profiler trace of the enclosed ops
    (jax.profiler) — the RenderDoc-capture analogue (sort.cpp:271-301)."""
    return jax.profiler.trace(path)
