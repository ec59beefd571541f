"""Parameters of the tiled LSD radix sort that the oracles model.

The reference hard-codes its grid constants in *two* places (host
``groupX=108`` at radx_internal.hpp:143 vs. shader ``WG_COUNT`` 108/144/72 at
{RadX2-SM7-DEV,radix,radix-rapid}/partition.comp:14) and ships with a live
host/shader mismatch on two of its four shader variants.  Here the digit
width, pass count and tile size live in one frozen dataclass that the NumPy
and C++ oracles (``oracle/``) share, so that class of bug cannot exist.

The device operators take no configuration: each has one plain XLA path.

Reference parity notes:
  * ``bits_per_pass`` replaces the compile-time digit-width fork
    (8 bits / 4 passes on Turing, RadX2-SM7-DEV/includes.glsl:21-26;
    2 bits / 16 passes elsewhere, radix/includes.glsl:34-38).
  * ``tile_rows`` × 128 keys is the analogue of RadX's per-workgroup block
    (``get_blocks_info``, RadX2-SM7-DEV/includes.glsl:171-182).
"""

from __future__ import annotations

import dataclasses

TILE_LANES = 128  # keys per tile row in the oracles' tiling


@dataclasses.dataclass(frozen=True)
class SortConfig:
    """Configuration of the oracles' LSD radix sort.

    Attributes:
      key_bits: total key width (uint32 → 32).
      bits_per_pass: digit width per LSD pass (8 → 256 radices, 4 passes).
      tile_rows: rows per tile; a tile holds ``tile_rows * 128`` keys
        (the granularity of the per-tile histograms and ranks).
    """

    key_bits: int = 32
    bits_per_pass: int = 8
    tile_rows: int = 16

    @property
    def radix(self) -> int:
        return 1 << self.bits_per_pass

    @property
    def num_passes(self) -> int:
        return -(-self.key_bits // self.bits_per_pass)

    @property
    def tile_elems(self) -> int:
        return self.tile_rows * TILE_LANES

    @property
    def digit_mask(self) -> int:
        return self.radix - 1

    def __post_init__(self):
        if self.bits_per_pass not in (1, 2, 4, 8, 16):
            raise ValueError(f"unsupported bits_per_pass={self.bits_per_pass}")
        if self.tile_rows < 1:
            raise ValueError("tile_rows must be >= 1")


def cdiv(a: int, b: int) -> int:
    """Ceil division (the reference's ``tiled()``, radx_utils.hpp:10-14)."""
    return -(-a // b)


DEFAULT = SortConfig()
