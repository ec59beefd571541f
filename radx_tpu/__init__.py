"""radx_tpu — a vectorized query-execution engine in JAX.

Built from scratch (JAX / XLA) with the capabilities of the RadX Vulkan
radix-sort library (BenjaminXiang/RadX):

  * Sorts of uint32/int32/float32/64-bit keys, with payloads, stable
    argsort and multi-column keys (ops/sort.py).  The engine is a stable
    ``lax.sort``, which XLA's GPU backend lowers to CUB's LSD radix sort —
    the design RadX implements with per-workgroup histograms, prefix scans
    and ballot-ranked scatters.
  * Relational operators on the same primitives (ops/core.py): filter,
    sparse and dense group-by, inner/left/multi-match joins, top-k,
    distinct, and single-jit lazy pipelines (ops/lazy.py).
  * Multi-device sort via jax.sharding.Mesh + shard_map
    (parallel/dist_sort.py): local sort → all_gather'ed sample splitters
    (skew-bounded: every device receives ≤ N/D + N/(64·D) keys under any
    distribution) → slot-packed ppermute exchange waves → one local sort.
  * Bit-exact CPU oracles (NumPy + native C++) as the correctness gate.
"""

import os as _os


def _enable_compile_cache():
    """Persistent XLA compile cache in the checkout (``.jax_cache/``) — the
    analogue of the reference's vk::PipelineCache (radx_implement.inl:
    269-273), which it creates but never serializes.  Where
    JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    set here."""
    if "JAX_COMPILATION_CACHE_DIR" in _os.environ:
        return
    import jax

    repo = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    jax.config.update(
        "jax_compilation_cache_dir", _os.path.join(repo, ".jax_cache")
    )
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


_enable_compile_cache()

from radx_tpu.config import SortConfig, DEFAULT  # noqa: F401,E402
from radx_tpu.ops.sort import (  # noqa: F401,E402
    argsort,
    sort,
    sort_any,
    sort_pairs,
    sort_pairs_any,
    sort_u64,
)
from radx_tpu.ops.filter import filter_columns  # noqa: F401,E402
from radx_tpu.ops.topk import top_k  # noqa: F401,E402
from radx_tpu.ops.distinct import unique  # noqa: F401,E402
from radx_tpu.ops.groupby import groupby, groupby_dense  # noqa: F401,E402
from radx_tpu.ops.table import Table  # noqa: F401,E402
from radx_tpu.ops.lazy import LazyTable  # noqa: F401,E402

__version__ = "0.5.0"
