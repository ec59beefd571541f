"""Native host runtime (C++ via ctypes): data generation, validation,
staging — the engine's counterpart of the reference's C++ host
harness (ComputeFramework/TestSort, src/test/sort.cpp)."""

from radx_tpu.runtime.native import (  # noqa: F401
    gen_permutation,
    gen_skewed,
    gen_uniform,
    validate_sort,
)
