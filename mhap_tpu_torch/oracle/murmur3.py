"""NumPy oracle for the hash functions used by the MHAP overlap algorithm
(the port's copy of mhap_tpu/oracle/murmur3.py).

The reference (marbl/MHAP v2.1.3) hashes every k-mer substring with guava's
murmur3 over the *UTF-16 code units* of the Java string
(``Hasher.putUnencodedChars``, see reference sketch/HashUtils.java:237-258 and
:213-235).  For ASCII sequence data this is exactly MurmurHash3 applied to the
UTF-16LE byte expansion (each char -> [code, 0x00]).

Two variants are used on the overlap path:

* ``murmur3_128``  (MurmurHash3 x64_128, first 64 bits a.k.a. guava
  ``HashCode.asLong()``) -- stage-1 k-mer identity hashes.
* ``murmur3_32``   (MurmurHash3 x86_32, guava ``HashCode.asInt()``) -- stage-2
  ordered-sketch k-mer hashes.

This module is the *parity oracle*: a slow-but-clear vectorized NumPy
implementation that the device hashes (ops/murmur3.py) are tested
against bit-for-bit.  It is validated against a canonical C implementation
(native/murmur3.c).

All arithmetic is modulo 2**64 / 2**32 (numpy uint64/uint32 wraparound).
"""

from __future__ import annotations

import numpy as np

_C1_128 = np.uint64(0x87C37B91114253D5)
_C2_128 = np.uint64(0x4CF5AD432745937F)

_FMIX1 = np.uint64(0xFF51AFD7ED558CCD)
_FMIX2 = np.uint64(0xC4CEB9FE1A85EC53)

_C1_32 = np.uint32(0xCC9E2D51)
_C2_32 = np.uint32(0x1B873593)


def _rotl64(x: np.ndarray, r: int) -> np.ndarray:
    r = np.uint64(r)
    return (x << r) | (x >> (np.uint64(64) - r))


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    r = np.uint32(r)
    return (x << r) | (x >> (np.uint32(32) - r))


def _fmix64(k: np.ndarray) -> np.ndarray:
    k = k ^ (k >> np.uint64(33))
    k = k * _FMIX1
    k = k ^ (k >> np.uint64(33))
    k = k * _FMIX2
    k = k ^ (k >> np.uint64(33))
    return k


def _fmix32(h: np.ndarray) -> np.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return h


def _bytes_to_u64_le(blocks: np.ndarray) -> np.ndarray:
    """[..., 8] uint8 -> [...] uint64 little-endian."""
    b = blocks.astype(np.uint64)
    out = np.zeros(blocks.shape[:-1], dtype=np.uint64)
    for i in range(8):
        out |= b[..., i] << np.uint64(8 * i)
    return out


def _bytes_to_u32_le(blocks: np.ndarray) -> np.ndarray:
    """[..., 4] uint8 -> [...] uint32 little-endian."""
    b = blocks.astype(np.uint32)
    out = np.zeros(blocks.shape[:-1], dtype=np.uint32)
    for i in range(4):
        out |= b[..., i] << np.uint32(8 * i)
    return out


def murmur3_x64_128(data: np.ndarray, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """MurmurHash3 x64_128 over rows of a byte matrix.

    data: [n, nbytes] uint8 (every row hashed independently; all rows same
    length -- exactly the k-mer case).  Returns (h1, h2) as uint64 arrays [n].
    Seed is sign-extended like guava's ``Murmur3_128Hasher(int seed)``.
    """
    data = np.atleast_2d(np.asarray(data, dtype=np.uint8))
    n, nbytes = data.shape
    # Java: long h1 = seed (sign-extended 32->64)
    seed64 = np.uint64(np.int64(np.int32(np.uint32(seed & 0xFFFFFFFF))))
    h1 = np.full(n, seed64, dtype=np.uint64)
    h2 = np.full(n, seed64, dtype=np.uint64)

    nblocks = nbytes // 16
    for blk in range(nblocks):
        k1 = _bytes_to_u64_le(data[:, blk * 16: blk * 16 + 8])
        k2 = _bytes_to_u64_le(data[:, blk * 16 + 8: blk * 16 + 16])

        k1 = k1 * _C1_128
        k1 = _rotl64(k1, 31)
        k1 = k1 * _C2_128
        h1 = h1 ^ k1
        h1 = _rotl64(h1, 27)
        h1 = h1 + h2
        h1 = h1 * np.uint64(5) + np.uint64(0x52DCE729)

        k2 = k2 * _C2_128
        k2 = _rotl64(k2, 33)
        k2 = k2 * _C1_128
        h2 = h2 ^ k2
        h2 = _rotl64(h2, 31)
        h2 = h2 + h1
        h2 = h2 * np.uint64(5) + np.uint64(0x38495AB5)

    tail = nbytes - nblocks * 16
    if tail > 0:
        tb = np.zeros((n, 16), dtype=np.uint8)
        tb[:, :tail] = data[:, nblocks * 16:]
        k1 = _bytes_to_u64_le(tb[:, :8])
        k2 = _bytes_to_u64_le(tb[:, 8:16])
        if tail > 8:
            k2 = k2 * _C2_128
            k2 = _rotl64(k2, 33)
            k2 = k2 * _C1_128
            h2 = h2 ^ k2
        k1 = k1 * _C1_128
        k1 = _rotl64(k1, 31)
        k1 = k1 * _C2_128
        h1 = h1 ^ k1

    ln = np.uint64(nbytes)
    h1 = h1 ^ ln
    h2 = h2 ^ ln
    h1 = h1 + h2
    h2 = h2 + h1
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = h1 + h2
    h2 = h2 + h1
    return h1, h2


def murmur3_x86_32(data: np.ndarray, seed: int = 0) -> np.ndarray:
    """MurmurHash3 x86_32 over rows of a byte matrix [n, nbytes] -> uint32 [n]."""
    data = np.atleast_2d(np.asarray(data, dtype=np.uint8))
    n, nbytes = data.shape
    h1 = np.full(n, np.uint32(seed & 0xFFFFFFFF), dtype=np.uint32)

    nblocks = nbytes // 4
    for blk in range(nblocks):
        k1 = _bytes_to_u32_le(data[:, blk * 4: blk * 4 + 4])
        k1 = k1 * _C1_32
        k1 = _rotl32(k1, 15)
        k1 = k1 * _C2_32
        h1 = h1 ^ k1
        h1 = _rotl32(h1, 13)
        h1 = h1 * np.uint32(5) + np.uint32(0xE6546B64)

    tail = nbytes - nblocks * 4
    if tail > 0:
        tb = np.zeros((n, 4), dtype=np.uint8)
        tb[:, :tail] = data[:, nblocks * 4:]
        k1 = _bytes_to_u32_le(tb)
        k1 = k1 * _C1_32
        k1 = _rotl32(k1, 15)
        k1 = k1 * _C2_32
        h1 = h1 ^ k1

    h1 = h1 ^ np.uint32(nbytes)
    return _fmix32(h1)


def utf16le_bytes(strings: np.ndarray) -> np.ndarray:
    """ASCII code matrix [n, k] uint8 -> UTF-16LE byte matrix [n, 2k] uint8.

    Mirrors guava ``putUnencodedChars`` on ASCII Java strings.
    """
    codes = np.asarray(strings, dtype=np.uint8)
    n, k = codes.shape
    out = np.zeros((n, 2 * k), dtype=np.uint8)
    out[:, 0::2] = codes
    return out


def hash_kmers_128(kmer_codes: np.ndarray, seed: int = 0) -> np.ndarray:
    """Hash rows of an ASCII-code k-mer matrix [n, k] with guava-style
    murmur3_128 over UTF-16 chars; returns h1 (``asLong``) as uint64 [n].

    Parity: reference HashUtils.computeSequenceHashesLong (one k-mer per row).
    """
    h1, _ = murmur3_x64_128(utf16le_bytes(kmer_codes), seed)
    return h1


def hash_kmers_32(kmer_codes: np.ndarray) -> np.ndarray:
    """Guava-style murmur3_32(seed=0) over UTF-16 chars; uint32 [n].

    Parity: reference HashUtils.computeSequenceHashes.
    """
    return murmur3_x86_32(utf16le_bytes(kmer_codes), 0)
