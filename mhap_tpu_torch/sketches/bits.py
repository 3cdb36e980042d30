"""Bit-sketch family (secondary sketch layer, SURVEY.md section 2.3; the
port's copy of mhap_tpu/sketches/bits.py).

Parity targets:
  * sketch/AbstractBitSketch.java -- long[] bit words, intersection count
    = numBits - popcount(xor) (:75-89), similarity = matching-bit fraction
  * sketch/MinHashBitSketch.java -- 1-bit MinHash: the LAST bit of each
    min-hash slot packed MSB-first into 64-bit words (:38-66); jaccard =
    max(0, 2*(sim-0.5)) (:83-91)
  * sketch/SimHash.java -- per-bit votes over exact per-(kmer,word)
    murmur3_128 hashes (guava putUnencodedChars(kmer).putInt(word)),
    sign bit per counter (:40-87)
  * sketch/HashUtils.computeNGramHashes (:161-192, xorshift expansion) and
    computeNGramHashesExact (:194-211)

Host representation is numpy uint64 words; ``bit_similarity_matrix`` is
the batched comparison on a device, CUDA kernel 6 (csrc/bits.cu) on the
card and its plain version (ops/bits.py) on the CPU.
"""

from __future__ import annotations

import numpy as np

from ..oracle import murmur3 as _m3
from ..oracle import sketch as _osk


def compute_ngram_hashes(seq: str, ngram: int, num_words: int,
                         seed: int = 0) -> np.ndarray:
    """xorshift expansion of each k-mer identity hash -> uint64 [n, W]
    (HashUtils.computeNGramHashes :161-192)."""
    x = _osk.sequence_kmer_hashes_128(seq, ngram, seed)
    out = np.empty((len(x), num_words), np.uint64)
    for w in range(num_words):
        x = _osk.xorshift64(x)
        out[:, w] = x
    return out


def compute_ngram_hashes_exact(seq: str, ngram: int, num_words: int,
                               seed: int = 0) -> np.ndarray:
    """murmur3_128(seed) over utf16le(kmer) + int32be(word) -> uint64 [n, W]
    (HashUtils.computeNGramHashesExact :194-211; guava putInt is
    little-endian, putUnencodedChars little-endian code units)."""
    n = len(seq) - ngram + 1
    if n < 1:
        raise _osk.ZeroNGramsFound("N-gram size bigger than string length.")
    out = np.empty((n, num_words), np.uint64)
    for i in range(n):
        base = seq[i:i + ngram].encode("utf-16-le")
        for w in range(num_words):
            data = np.frombuffer(
                base + int(w).to_bytes(4, "little"), dtype=np.uint8)
            h1, _ = _m3.murmur3_x64_128(data.reshape(1, -1), seed)
            out[i, w] = h1[0]
    return out


class BitSketch:
    """AbstractBitSketch: uint64 word array + popcount similarity."""

    def __init__(self, bits: np.ndarray):
        self.bits = np.asarray(bits, dtype=np.uint64)

    def number_of_bits(self) -> int:
        return len(self.bits) * 64

    def get_bit(self, index: int) -> bool:
        word = self.bits[index // 64]
        return bool((int(word) >> (index % 64)) & 1)

    def get_intersection_count(self, other: "BitSketch") -> int:
        if len(self.bits) != len(other.bits):
            raise ValueError("Size of bits in tables must match.")
        xor = self.bits ^ other.bits
        diff = int(np.unpackbits(xor.view(np.uint8)).sum())
        return self.number_of_bits() - diff

    def similarity(self, other: "BitSketch") -> float:
        return self.get_intersection_count(other) / self.number_of_bits()


def pack_last_bits_msb_first(values) -> np.ndarray:
    """MinHashBitSketch.getAsBits: last bit of each int, packed so the
    first value lands in the word's MSB (:38-66).  ``values`` [..., n]
    -> uint64 [..., n // 64]: each row packs on its own, and a tail
    shorter than a word is dropped, as in the reference."""
    values = np.asarray(values)
    num_words = values.shape[-1] // 64
    last = (values[..., :num_words * 64] & 1).astype(np.uint8)
    packed = np.packbits(last.reshape(*values.shape[:-1], num_words, 64),
                         axis=-1)  # 8 bytes a word, first value in the MSB
    return packed.view(">u8")[..., 0].astype(np.uint64)


class MinHashBitSketch(BitSketch):
    def __init__(self, source, ngram: int = None, num_words: int = None):
        if isinstance(source, str):
            # reference ctor uses canonical k-mers + legacy weights
            # (MinHashBitSketch.java:76-79 -> MinHashSketch(…, doRC=true))
            mh = _osk.minhash_sketch(source, ngram, num_words * 64,
                                     canonical=True)
            super().__init__(pack_last_bits_msb_first(mh))
        elif np.asarray(source).dtype == np.uint64:
            super().__init__(source)
        else:
            super().__init__(pack_last_bits_msb_first(source))

    def jaccard(self, other: "MinHashBitSketch") -> float:
        sim = self.get_intersection_count(other) / self.number_of_bits()
        return max(0.0, (sim - 0.5) * 2.0)


class SimHash(BitSketch):
    def __init__(self, seq: str, ngram: int, num_words: int):
        hashes = compute_ngram_hashes_exact(seq, ngram, num_words, 0)
        counts = np.zeros(num_words * 64, np.int64)
        for w in range(num_words):
            vals = hashes[:, w]
            for bit in range(64):
                b = ((vals >> np.uint64(bit)) & np.uint64(1)).astype(np.int64)
                counts[w * 64 + bit] += int((2 * b - 1).sum())
        bits = np.zeros(num_words, np.uint64)
        for w in range(num_words):
            val = 0
            for bit in range(64):
                if counts[w * 64 + bit] > 0:
                    val |= 1 << bit
            bits[w] = val
        super().__init__(bits)

    def jaccard(self, other: "SimHash") -> float:
        sim = self.get_intersection_count(other) / self.number_of_bits()
        return max(0.0, (sim - 0.5) * 2.0)


def bit_similarity_matrix(a_bits, b_bits, device="cuda"):
    """Batched similarity of every row of ``a_bits`` [NA, W] with every
    row of ``b_bits`` [NB, W] (numpy arrays or tensors of uint32 or
    uint64 words, 32 or 64 bits a word, one width for both): float32
    [NA, NB] on ``device``, 1 - popcount(a ^ b) / (bits * W) in float32,
    which is ``BitSketch.similarity`` for every word width.

    The JAX package's version (jax.lax.population_count) is equal on
    uint32 words, but under JAX's 32-bit default it casts uint64 words to
    uint32 and drops their high halves; this one does not.  Kernel 6 on
    the card, its plain version on the CPU.
    """
    # torch only here: the host tools that use the sketches never load it
    from ..device import resolve_device
    from ..ops.bits import words
    from ..ops.bits_kernels import bit_similarity

    dev = resolve_device(device)
    return bit_similarity(words(a_bits, dev), words(b_bits, dev))
