"""NumPy reference implementation of the tiled LSD radix sort.

Mirrors the reference's three-phase per-pass decomposition exactly so that
*intermediate* states (per-tile histograms, scanned bases, destinations) are
comparable between the NumPy and C++ oracles, not just final outputs:

  phase 1  per-tile digit histogram   — counting.comp   (RadX2-SM7-DEV/counting.comp:50-73)
  phase 2  hierarchical prefix scan   — partition.comp  (RadX2-SM7-DEV/partition.comp:38-72)
  phase 3  stable rank-and-scatter    — scattering.comp (RadX2-SM7-DEV/scattering.comp:68-130)

The tile blocking corresponds to RadX's per-workgroup contiguous blocks
(``get_blocks_info``, RadX2-SM7-DEV/includes.glsl:171-182).  Ping-pong across
passes matches ``keys[Shift&1] → keysOut[1-(Shift&1)]``
(RadX2-SM7-DEV/scattering.comp:28,126).  Unlike the reference (whose CPU
oracle is timed but never compared, src/test/sort.cpp:452-469), this oracle
*is* the correctness gate for every kernel in the engine.
"""

from __future__ import annotations

import numpy as np

from radx_tpu.config import SortConfig, cdiv


def extract_digit(keys: np.ndarray, shift: int, mask: int) -> np.ndarray:
    """Digit extraction — ``extractKey`` (RadX2-SM7-DEV/includes.glsl:103-109)."""
    return ((keys >> np.uint32(shift)) & np.uint32(mask)).astype(np.int64)


def tile_histograms(digits: np.ndarray, tile: int, radix: int) -> np.ndarray:
    """Phase 1: per-tile digit histogram ``counts[tile][digit]``."""
    n = digits.shape[0]
    ntiles = cdiv(n, tile)
    counts = np.zeros((ntiles, radix), dtype=np.int64)
    for t in range(ntiles):
        seg = digits[t * tile : (t + 1) * tile]
        counts[t] = np.bincount(seg, minlength=radix)
    return counts


def scan_bases(counts: np.ndarray) -> np.ndarray:
    """Phase 2: two-level exclusive scan → global base per (tile, digit).

    base[t, k] = (number of keys with digit < k anywhere)
               + (number of keys with digit == k in tiles < t)
    — exactly partition.comp's phase-1 cross-workgroup scan followed by its
    phase-2 cross-radice scan (RadX2-SM7-DEV/partition.comp:38-72).
    """
    within_digit = np.cumsum(counts, axis=0) - counts  # exclusive over tiles
    totals = counts.sum(axis=0)
    digit_base = np.cumsum(totals) - totals  # exclusive over digits
    return digit_base[None, :] + within_digit


def rank_and_destinations(
    digits: np.ndarray, bases: np.ndarray, tile: int
) -> np.ndarray:
    """Phase 3a: stable per-key destination = base[tile, digit] + intra-tile rank.

    The intra-tile stable rank (count of equal digits at earlier positions in
    the tile) is what RadX computes with ``subgroupPartitionNV`` masks and the
    serialized per-wave critical section (scattering.comp:94-102, 125-127).
    """
    n = digits.shape[0]
    dest = np.empty(n, dtype=np.int64)
    radix = bases.shape[1]
    for t in range(cdiv(n, tile)):
        seg = digits[t * tile : (t + 1) * tile]
        running = np.zeros(radix, dtype=np.int64)
        # rank[i] = running count of seg[i] before i  (vectorized per digit)
        ranks = np.empty_like(seg)
        for k in range(radix):
            sel = seg == k
            cnt = int(sel.sum())
            if cnt:
                ranks[sel] = np.arange(cnt)
        dest[t * tile : t * tile + seg.shape[0]] = bases[t, seg] + ranks
    return dest


def radix_pass(
    keys: np.ndarray,
    shift: int,
    cfg: SortConfig,
    payload: np.ndarray | None = None,
):
    """One full LSD pass: histogram → scan → rank-and-scatter."""
    digits = extract_digit(keys, shift, cfg.digit_mask)
    counts = tile_histograms(digits, cfg.tile_elems, cfg.radix)
    bases = scan_bases(counts)
    dest = rank_and_destinations(digits, bases, cfg.tile_elems)
    out = np.empty_like(keys)
    out[dest] = keys
    if payload is None:
        return out, None
    pout = np.empty_like(payload)
    pout[dest] = payload
    return out, pout


def sort_u32(keys: np.ndarray, cfg: SortConfig | None = None) -> np.ndarray:
    """Full LSD radix sort of uint32 keys (ascending, stable)."""
    cfg = cfg or SortConfig()
    keys = np.asarray(keys, dtype=np.uint32)
    for p in range(cfg.num_passes):
        keys, _ = radix_pass(keys, p * cfg.bits_per_pass, cfg)
    return keys


def sort_pairs(
    keys: np.ndarray, payload: np.ndarray, cfg: SortConfig | None = None
):
    """Stable key+payload sort — the capability RadX stubs but never ships
    (indiction/permutation pipelines created yet never dispatched,
    radx_internal.hpp:139, radix/indiction.comp:22-28)."""
    cfg = cfg or SortConfig()
    keys = np.asarray(keys, dtype=np.uint32)
    payload = np.asarray(payload)
    for p in range(cfg.num_passes):
        keys, payload = radix_pass(keys, p * cfg.bits_per_pass, cfg, payload)
    return keys, payload
