"""Bit-exact MersenneTwisterFast (MT19937) port (the port's copy of
mhap_tpu/utils/mersenne.py).

Parity target: utils/MersenneTwisterFast.java (Sean Luke's strictfp
implementation): setSeed(long) uses mt[0] = low 32 bits of the seed and
the Knuth 1812433253 initializer (:335-358); nextInt tempering (:410-443);
nextDouble = ((y>>>6)<<27 + (z>>>5)) / 2^53 (:895-960); nextInt(n) with
the power-of-2 shortcut and rejection loop (:1238-1330); nextGaussian via
the Marsaglia polar method with one cached value (:1003-1130).
"""

from __future__ import annotations

import math

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF
_MASK32 = 0xFFFFFFFF


class MersenneTwisterFast:
    def __init__(self, seed: int = 4357):
        self.set_seed(seed)

    def set_seed(self, seed: int) -> None:
        self._have_gauss = False
        self._next_gauss = 0.0
        mt = [0] * _N
        mt[0] = seed & _MASK32
        for i in range(1, _N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> 30)) + i) & _MASK32
        self.mt = mt
        self.mti = _N

    def _gen(self) -> None:
        mt = self.mt
        for kk in range(_N - _M):
            y = (mt[kk] & _UPPER) | (mt[kk + 1] & _LOWER)
            mt[kk] = mt[kk + _M] ^ (y >> 1) ^ (_MATRIX_A if y & 1 else 0)
        for kk in range(_N - _M, _N - 1):
            y = (mt[kk] & _UPPER) | (mt[kk + 1] & _LOWER)
            mt[kk] = mt[kk + _M - _N] ^ (y >> 1) ^ (_MATRIX_A if y & 1 else 0)
        y = (mt[_N - 1] & _UPPER) | (mt[0] & _LOWER)
        mt[_N - 1] = mt[_M - 1] ^ (y >> 1) ^ (_MATRIX_A if y & 1 else 0)
        self.mti = 0

    def _next32(self) -> int:
        if self.mti >= _N:
            self._gen()
        y = self.mt[self.mti]
        self.mti += 1
        y ^= y >> 11
        y = (y ^ ((y << 7) & 0x9D2C5680)) & _MASK32
        y = (y ^ ((y << 15) & 0xEFC60000)) & _MASK32
        y ^= y >> 18
        return y

    def next_int32(self) -> int:
        y = self._next32()
        return y - (1 << 32) if y >= (1 << 31) else y

    def next_int(self, n: int) -> int:
        if n <= 0:
            raise ValueError(f"n must be positive, got: {n}")
        if (n & -n) == n:
            return (n * (self._next32() >> 1)) >> 31
        while True:
            bits = self._next32() >> 1
            val = bits % n
            if bits - val + (n - 1) < (1 << 31):
                return val

    def next_double(self) -> float:
        y = self._next32()
        z = self._next32()
        return (((y >> 6) << 27) + (z >> 5)) / float(1 << 53)

    def next_gaussian(self) -> float:
        if self._have_gauss:
            self._have_gauss = False
            return self._next_gauss
        while True:
            v1 = 2 * self.next_double() - 1
            v2 = 2 * self.next_double() - 1
            s = v1 * v1 + v2 * v2
            if 0 < s < 1:
                break
        mult = math.sqrt(-2 * math.log(s) / s)
        self._next_gauss = v2 * mult
        self._have_gauss = True
        return v1 * mult
