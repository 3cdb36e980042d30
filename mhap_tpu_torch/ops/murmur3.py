"""Batched murmur3 k-mer hashing in plain PyTorch (counterpart of
mhap_tpu/ops/murmur3.py; XLA there, elementwise torch here, so no kernel).

Same values as guava's murmur3 over the UTF-16 chars of Java k-mer
substrings (reference sketch/HashUtils.java):

* ``kmer_hashes_128(seq, k)`` -> h1 ("asLong") of murmur3 x64_128 per
  window, one int64 per window (two's-complement bit pattern of the Java
  ``long``);
* ``kmer_hashes_32(seq, k)``  -> murmur3 x86_32 per window, int32;
* ``murmur3_128_long(x)`` -> both halves (h1, h2) of murmur3 x64_128 of
  int64 values, each taken as its 8 little-endian bytes (guava's
  ``Hasher.putLong``): the funnel of the Guava bloom filter
  (io/filter.py).

Input is a [B, L] uint8 tensor of upper-cased ASCII codes; every window is
hashed (the caller masks windows past a read's end).  Each char is the
UTF-16LE byte pair (code, 0), so a k-mer is 2k bytes, 4 chars per 64-bit
word.  Arithmetic is native int64: ``*`` and ``<<`` wrap modulo 2^64, and
Java's logical ``>>>`` is torch's arithmetic ``>>`` followed by a mask.
"""

from __future__ import annotations

import torch

I64 = torch.int64

# 64-bit constants above 2^63 written as their signed int64 values
_C1_128 = -8663945395140668459   # 0x87C37B91114253D5
_C2_128 = 5545529020109919103    # 0x4CF5AD432745937F
_FMIX1 = -49064778989728563      # 0xFF51AFD7ED558CCD
_FMIX2 = -4265267296055464877    # 0xC4CEB9FE1A85EC53
_M32 = 0xFFFFFFFF


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns (Java ``>>>``)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def _fmix64(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr(h, 33)
    h = h * _FMIX1
    h = h ^ _shr(h, 33)
    h = h * _FMIX2
    return h ^ _shr(h, 33)


def _char(seq: torch.Tensor, j: int, n: int) -> torch.Tensor:
    """[B, n] int64 view of char j of every window."""
    return seq[:, j:j + n].to(I64)


def kmer_hashes_128(seq: torch.Tensor, k: int, seed: int = 0) -> torch.Tensor:
    """Guava murmur3_128 h1 over the UTF-16 chars of every k-mer window.

    seq: [B, L] uint8.  Returns int64 [B, L-k+1]."""
    B, L = seq.shape
    n = L - k + 1
    zero = torch.zeros((B, n), dtype=I64, device=seq.device)

    def ch(i):
        return _char(seq, i, n) if i < k else zero

    def word(j):
        """u64 from chars j..j+3 (UTF-16LE), zero past the k-mer."""
        return (ch(j) | (ch(j + 1) << 16) | (ch(j + 2) << 32)
                | (ch(j + 3) << 48))

    # Java: long h1 = seed (int, sign-extended)
    s = seed - (1 << 32) if seed & 0x80000000 else seed & _M32
    h1 = torch.full((B, n), s, dtype=I64, device=seq.device)
    h2 = h1.clone()
    nbytes = 2 * k
    nblocks = nbytes // 16
    for b in range(nblocks):
        k1 = _rotl64(word(8 * b) * _C1_128, 31) * _C2_128
        h1 = _rotl64(h1 ^ k1, 27) + h2
        h1 = h1 * 5 + 0x52DCE729
        k2 = _rotl64(word(8 * b + 4) * _C2_128, 33) * _C1_128
        h2 = _rotl64(h2 ^ k2, 31) + h1
        h2 = h2 * 5 + 0x38495AB5
    tail = nbytes - nblocks * 16
    if tail > 0:
        j0 = 8 * nblocks
        if tail > 8:
            h2 = h2 ^ (_rotl64(word(j0 + 4) * _C2_128, 33) * _C1_128)
        h1 = h1 ^ (_rotl64(word(j0) * _C1_128, 31) * _C2_128)
    h1 = h1 ^ nbytes
    h2 = h2 ^ nbytes
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    return h1 + h2


def murmur3_128_long(x: torch.Tensor, seed: int = 0):
    """Guava murmur3_128 of each int64 value of x as 8 little-endian
    bytes: (h1, h2), the two int64 halves of the 128-bit hash (HashCode
    bytes 0-7 and 8-15).  Eight bytes make no full 16-byte block, so the
    value is the tail's k1."""
    s = seed - (1 << 32) if seed & 0x80000000 else seed & _M32
    k1 = _rotl64(x.to(I64) * _C1_128, 31) * _C2_128
    h1 = (k1 ^ s) ^ 8
    h2 = torch.full_like(h1, s ^ 8)
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = h1 + h2
    return h1, h2 + h1


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def kmer_hashes_32(seq: torch.Tensor, k: int, seed: int = 0) -> torch.Tensor:
    """Guava murmur3_32 over the UTF-16 chars of every k-mer window.

    seq: [B, L] uint8.  Returns int32 [B, L-k+1] (signed, as Java ints).
    The 32-bit words live in the low half of int64 lanes and are masked
    after every multiply, so products never leave the exact range."""
    B, L = seq.shape
    n = L - k + 1
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h1 = torch.full((B, n), seed & _M32, dtype=I64, device=seq.device)
    nbytes = 2 * k
    for b in range(nbytes // 4):
        k1 = _char(seq, 2 * b, n) | (_char(seq, 2 * b + 1, n) << 16)
        k1 = (_rotl32((k1 * c1) & _M32, 15) * c2) & _M32
        h1 = _rotl32(h1 ^ k1, 13)
        h1 = (h1 * 5 + 0xE6546B64) & _M32
    if k % 2 == 1:  # 2-byte tail (one char)
        k1 = _char(seq, k - 1, n)
        k1 = (_rotl32((k1 * c1) & _M32, 15) * c2) & _M32
        h1 = h1 ^ k1
    h1 = h1 ^ nbytes
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xC2B2AE35) & _M32
    h1 = h1 ^ (h1 >> 16)
    return (h1 - ((h1 >> 31) << 32)).to(torch.int32)
