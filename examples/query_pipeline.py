"""End-to-end query pipeline on the columnar Table API.

Sales-style demo: filter rows, aggregate per group, join against a
dimension table, and sort the result — eagerly, lazily with one host sync,
and as one jitted program; every step is checked against NumPy.

Run on the GPU (2^27 sales rows by default):
  python examples/query_pipeline.py
Run a small table on the CPU (the row count must be given there):
  JAX_PLATFORMS=cpu python examples/query_pipeline.py --rows 100000
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from radx_tpu import runtime  # noqa: E402
from radx_tpu.ops.lazy import LazyTable  # noqa: E402
from radx_tpu.ops.table import Table  # noqa: E402

N_STORES = 50


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=None,
                    help="sales rows (default 2^27; required off the GPU)")
    args = ap.parse_args(argv)
    n = args.rows
    if n is None:
        if jax.devices()[0].platform != "gpu":
            sys.exit("query_pipeline: no GPU; pass --rows to run a small "
                     "table on this backend")
        n = 1 << 27

    store = runtime.gen_uniform(n, 1) % np.uint32(N_STORES)
    amount = runtime.gen_uniform(n, 2) % np.uint32(500) + np.uint32(1)
    returned = (runtime.gen_uniform(n, 3) % np.uint32(20) == 0).astype(
        np.uint32)
    sales = Table.from_arrays(store=store, amount=amount, returned=returned)
    stores = Table.from_arrays(
        store=np.arange(N_STORES, dtype=np.uint32),
        region=(np.arange(N_STORES, dtype=np.uint32) % 7),
    )

    kept = sales.filter(sales.column("returned") == 0)
    per_store = kept.groupby("store", "amount", "sum")
    with_region = per_store.join(
        stores, on="store", value="sum", other_value="region"
    )
    top = with_region.sort_by("sum", descending=True)

    # selection + dedup operators on the same tables
    best3 = per_store.top_k("sum", 3)               # ORDER BY ... LIMIT 3
    regions = stores.distinct("region")             # SELECT DISTINCT
    assert best3.num_rows == 3 and regions.num_rows == 7
    # LEFT JOIN: every store appears, with sum = 0 where it sold nothing
    all_stores = stores.join(
        per_store, on="store", value="region", other_value="sum", how="left"
    )
    assert all_stores.num_rows == stores.num_rows

    out = top.to_numpy()
    print(f"top 5 of {N_STORES} stores by non-returned sales ({n} rows):")
    for i in range(5):
        print(f"  store {out['store'][i]:3d}  region {out['region'][i]}  "
              f"total {out['sum'][i]}")

    # cross-check against NumPy (uint32 sums wrap like the engine's)
    ok = returned == 0
    want = np.bincount(store[ok], weights=amount[ok], minlength=N_STORES)
    want = want.astype(np.uint64).astype(np.uint32)
    assert all(want[s] == t for s, t in zip(out["store"], out["sum"]))

    # --- the same pipeline, lazily: PROVABLY one host sync ----------------
    # The filter -> groupby -> join -> sort chain builds under a
    # device->host transfer guard that RAISES on any sync — the eager
    # Table's per-operator int(count) syncs would trip it.  collect() is
    # the single sync, performed after the guard exits.
    lt, ls = sales.lazy(), stores.lazy()
    with jax.transfer_guard_device_to_host("disallow"):
        kept = lt.filter(lt.column("returned") == 0)
        agg = kept.groupby("store", "amount", "sum")
        joined = agg.join(ls, on="store", value="sum", other_value="region")
        top_lazy = joined.sort_by("sum", descending=True)
    out_lazy = top_lazy.collect().to_numpy()  # <- the one sync
    assert all(want[s] == t for s, t in zip(out_lazy["store"], out_lazy["sum"]))
    print("lazy pipeline: zero syncs until collect() — verified by "
          "jax.transfer_guard_device_to_host('disallow')")

    # Same query as ONE fused XLA program: LazyTable is a pytree, so the
    # whole chain jits; collect() is the single device sync.
    @jax.jit
    def query(lt: LazyTable) -> LazyTable:
        kept = lt.filter(lt.column("returned") == 0)
        return kept.groupby("store", "amount", "sum").sort_by(
            "sum", descending=True
        )

    lazy_out = query(sales.lazy()).collect().to_numpy()
    assert all(want[s] == t for s, t in zip(lazy_out["store"], lazy_out["sum"]))
    assert list(lazy_out["sum"]) == sorted(lazy_out["sum"], reverse=True)
    print("lazy single-jit pipeline verified against NumPy (one host sync).")


if __name__ == "__main__":
    main()
