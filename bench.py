"""Headline benchmark: uint32 sort throughput, on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"spread_pct", "platform", "device_kind", "device_count", "suite"}.

Workload matches the reference harness: N = 2^23 shuffled uint32 keys
(src/test/sort.hpp:184, sort.cpp:348-350).  Baseline = the reference's
published ~1e9 keys/s on an RTX 2070 (README.md:18; BASELINE.md).

Timing: each call is timed on the host clock up to block_until_ready
(radx_tpu.utils.timing); the value is the median of the repeats and
spread_pct is (max - min) / median.  Unless RADX_BENCH_EXTRA=0 the
relational configs of radx_tpu.bench_suite run in the same process and
their rows go into "suite".  Exits non-zero when JAX finds no GPU.
"""

import json
import os

from radx_tpu import bench_suite

EXTRA_CONFIGS = (
    "pairs_4m",
    "pairs_unique_4m",
    "groupby_4m",
    "filter_64m",
    "topk_64m",
)


def main():
    bench_suite.require_gpu()
    primary = bench_suite.CONFIGS["sort_8m"]()
    suite = []
    if os.environ.get("RADX_BENCH_EXTRA", "1") != "0":
        suite = bench_suite.run_configs(EXTRA_CONFIGS)
    print(json.dumps({
        "metric": "sort_u32_keys_per_s_n2e23",
        "value": round(primary.items_per_s),
        "unit": "keys/s",
        "vs_baseline": round(primary.items_per_s / 1e9, 4),
        "spread_pct": round(primary.spread_pct, 2),
        **bench_suite.device_info(),
        "suite": suite,
    }))


if __name__ == "__main__":
    main()
