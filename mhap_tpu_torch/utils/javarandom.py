"""Bit-exact java.util.Random (48-bit LCG), the port's copy of
mhap_tpu/utils/javarandom.py.

EstimateROC pins ``new Random(0)`` for reproducible Monte-Carlo sampling
(reference main/EstimateROC.java:135,292); this mirror keeps the tool's
trial sequence identical to the reference's.
"""

from __future__ import annotations

_MULT = 0x5DEECE66D
_ADD = 0xB
_MASK = (1 << 48) - 1


class JavaRandom:
    def __init__(self, seed: int = 0):
        self.seed = (seed ^ _MULT) & _MASK

    def _next(self, bits: int) -> int:
        self.seed = (self.seed * _MULT + _ADD) & _MASK
        return self.seed >> (48 - bits)

    def next_int(self, bound: int) -> int:
        if bound <= 0:
            raise ValueError("bound must be positive")
        if (bound & -bound) == bound:  # power of two
            return (bound * self._next(31)) >> 31
        while True:
            bits = self._next(31)
            val = bits % bound
            # Java: bits - val + (bound-1) overflows int -> retry
            if bits - val + (bound - 1) < (1 << 31):
                return val

    def next_double(self) -> float:
        return ((self._next(26) << 27) + self._next(27)) / float(1 << 53)

    def next_boolean(self) -> bool:
        return self._next(1) != 0

    def next_int32(self) -> int:
        """Java nextInt(): signed 32-bit."""
        r = self._next(32)
        return r - (1 << 32) if r >= (1 << 31) else r
