"""Guava's murmur3 as MHAP calls it (reference sketch/HashUtils.java), in
plain PyTorch integer operations.

MHAP hashes each k-mer substring with ``Hasher.putUnencodedChars``: the
UTF-16 code units of the Java string, which for ASCII are the bytes
(code, 0).  So a k-mer of k chars is 2k bytes, four chars to a 64-bit
little-endian word.  int64 tensors carry the unsigned words: ``*``, ``+``
and ``<<`` wrap modulo 2^64, and Java's ``>>>`` is an arithmetic shift
followed by a mask.

Frozen from the definitions in the repository's NumPy oracle
(``mhap_tpu_torch/oracle/murmur3.py``, functions ``murmur3_x64_128`` and
``murmur3_x86_32``), rewritten over sliding windows of code rows.
"""

from __future__ import annotations

import torch

I64 = torch.int64
M32 = 0xFFFFFFFF


def _s64(u: int) -> int:
    """An unsigned 64-bit constant as the int64 with its bits."""
    return u - (1 << 64) if u >= 1 << 63 else u


C1_128 = _s64(0x87C37B91114253D5)
C2_128 = _s64(0x4CF5AD432745937F)
FMIX1 = _s64(0xFF51AFD7ED558CCD)
FMIX2 = _s64(0xC4CEB9FE1A85EC53)


def shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Java ``x >>> s`` on int64 bit patterns."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | shr(x, 64 - r)


def fmix64(k: torch.Tensor) -> torch.Tensor:
    k = k ^ shr(k, 33)
    k = k * FMIX1
    k = k ^ shr(k, 33)
    k = k * FMIX2
    return k ^ shr(k, 33)


def _char(codes: torch.Tensor, j: int, n: int) -> torch.Tensor:
    return codes[:, j:j + n].to(I64)


def hash128_windows(codes: torch.Tensor, k: int) -> torch.Tensor:
    """h1 (``HashCode.asLong``) of murmur3 x64_128, seed 0, over the
    UTF-16 chars of every k-char window of the [R, W] uint8 code rows:
    int64 [R, W - k + 1]."""
    R, W = codes.shape
    n = W - k + 1
    zero = torch.zeros((R, n), dtype=I64, device=codes.device)

    def word(j):  # chars j..j+3, zero past the window
        out = zero
        for t in range(4):
            if j + t < k:
                out = out | (_char(codes, j + t, n) << (16 * t))
        return out

    h1 = zero
    h2 = zero
    nbytes = 2 * k
    for b in range(nbytes // 16):
        k1 = rotl64(word(8 * b) * C1_128, 31) * C2_128
        h1 = rotl64(h1 ^ k1, 27) + h2
        h1 = h1 * 5 + 0x52DCE729
        k2 = rotl64(word(8 * b + 4) * C2_128, 33) * C1_128
        h2 = rotl64(h2 ^ k2, 31) + h1
        h2 = h2 * 5 + 0x38495AB5
    tail = nbytes % 16
    if tail:
        j0 = 8 * (nbytes // 16)
        if tail > 8:
            h2 = h2 ^ (rotl64(word(j0 + 4) * C2_128, 33) * C1_128)
        h1 = h1 ^ (rotl64(word(j0) * C1_128, 31) * C2_128)
    h1 = h1 ^ nbytes
    h2 = h2 ^ nbytes
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = fmix64(h1)
    h2 = fmix64(h2)
    return h1 + h2


def hash128_long(x: torch.Tensor):
    """(h1, h2) of murmur3 x64_128, seed 0, of each int64 as its 8
    little-endian bytes (Guava ``Hasher.putLong``, the bloom filter's
    funnel)."""
    k1 = rotl64(x.to(I64) * C1_128, 31) * C2_128
    h1 = k1 ^ 8
    h2 = torch.full_like(h1, 8)
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = fmix64(h1)
    h2 = fmix64(h2)
    h1 = h1 + h2
    return h1, h2 + h1


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def hash32_windows(codes: torch.Tensor, k: int) -> torch.Tensor:
    """murmur3 x86_32 (``HashCode.asInt``), seed 0, over the UTF-16 chars
    of every k-char window: int32 [R, W - k + 1], signed as Java's int.
    32-bit words sit in the low half of int64 lanes, masked after every
    product."""
    R, W = codes.shape
    n = W - k + 1
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = torch.zeros((R, n), dtype=I64, device=codes.device)
    for b in range(k // 2):  # one 4-byte block = two chars
        k1 = _char(codes, 2 * b, n) | (_char(codes, 2 * b + 1, n) << 16)
        k1 = (_rotl32((k1 * c1) & M32, 15) * c2) & M32
        h = _rotl32(h ^ k1, 13)
        h = (h * 5 + 0xE6546B64) & M32
    if k % 2:  # a 2-byte tail
        k1 = _char(codes, k - 1, n)
        h = h ^ ((_rotl32((k1 * c1) & M32, 15) * c2) & M32)
    h = h ^ (2 * k)
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & M32
    h = h ^ (h >> 16)
    return (h - ((h >> 31) << 32)).to(torch.int32)
