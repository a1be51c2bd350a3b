"""Static configuration dataclasses.

The reference configures everything at compile time through template
parameters (SURVEY.md §5.6; e.g. BinSize restricted to {16, 256, 65536} in
lib/sort/radix_cpu/include/radix_sort_cpu.hpp:26-31). The JAX equivalent is
frozen dataclasses whose fields become static arguments of jitted
functions.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RadixConfig:
    """Radix sort configuration.

    The reference restricts BinSize to {16, 256, 65536, 2^32}
    (radix_sort_cpu.hpp:26-31); we keep the same allowed set expressed as
    bits-per-pass.
    """

    bits_per_pass: int = 8

    def __post_init__(self):
        if self.bits_per_pass not in (4, 8, 16):
            raise ValueError("bits_per_pass must be one of {4, 8, 16}")

    @property
    def n_bins(self) -> int:
        return 1 << self.bits_per_pass

    @property
    def n_passes(self) -> int:
        return (32 + self.bits_per_pass - 1) // self.bits_per_pass
