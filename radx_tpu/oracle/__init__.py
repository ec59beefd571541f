"""Bit-exact CPU oracles (NumPy + native C++) for the engine.

The reference's only oracle is a parallel ``std::stable_sort`` that is timed
but never compared against the GPU output (src/test/sort.cpp:452-469).  Ours
is the correctness gate for every kernel path (BASELINE config 1).
"""

from radx_tpu.oracle import cpu, native  # noqa: F401
