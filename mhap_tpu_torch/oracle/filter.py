"""Oracle of MHAP's tf-idf / repeat k-mer filter (the port's copy of
mhap_tpu/oracle/filter.py; io/filter.py is the device path's reader).

Parity target: sketch/FrequencyCounts.java.

The filter file format (first line: ``<bloomSize> <repeatCount>``; rows:
``<kmer> <fraction> ...``) is parsed the same way; k-mers with fraction >=
filter_cutoff land in the fraction map keyed by the guava murmur3_128 h1 of
the (optionally canonicalized) k-mer string (FrequencyCounts.java:169-186).

Bloom-filter note: the reference stores *all* file k-mers in a guava
BloomFilter with 1e-5 FPR when suppress-noise > 0 (:137, :189-193), so
``keepKmer``/``scaledIdf`` see ~1e-5 false positives.  Two modes here:

  * exact set (default) -- cleaner, documented divergence (only matters
    for suppress-noise modes 1/2; changes nothing on a default run);
  * ``use_bloom=True`` -- a bit-compatible reimplementation of guava's
    ``BloomFilter.create(longFunnel, sizeBloom, 1e-5)`` with the
    MURMUR128_MITZ_64 strategy (GuavaBloomFilter below), sized from the
    filter file's header like the reference, for strict jar
    comparability of suppress-noise runs.
"""

from __future__ import annotations

import math

import numpy as np

from . import murmur3 as _m3
from .seq import reverse_complement


class GuavaBloomFilter:
    """Bit-compatible guava ``BloomFilter<Long>`` (strategy
    MURMUR128_MITZ_64, funnel ``sink.putLong(value)``).

    Parameters follow guava's BloomFilter.create(funnel, n, p):
      numBits = (long)(-n * ln(p) / ln(2)^2), rounded up to a multiple of
      64 by the backing long array; numHashFunctions = max(1,
      round(numBits/n * ln 2)).  put/mightContain hash the 8 little-endian
      bytes of the long with murmur3_128(seed=0) and probe
      ``(h1 + i*h2) & Long.MAX_VALUE mod bitSize`` for i in [0, k).
    """

    def __init__(self, expected_insertions: int, fpp: float = 1e-5):
        n = max(int(expected_insertions), 1)
        num_bits = int(-n * math.log(fpp) / (math.log(2) ** 2))
        num_bits = max(num_bits, 1)
        self.bit_size = ((num_bits + 63) // 64) * 64
        self.num_hashes = max(1, round(num_bits / n * math.log(2)))
        self.words = np.zeros(self.bit_size // 64, dtype=np.uint64)

    def probes(self, h) -> np.ndarray:
        """Probe bit indices for long value(s) h: [n, num_hashes] int64.

        Java: combinedHash starts at hash1 and adds hash2 each round;
        the index is (combinedHash & Long.MAX_VALUE) % bitSize."""
        hs = np.atleast_1d(np.asarray(h).astype(np.uint64))
        data = hs.astype("<u8").view(np.uint8).reshape(-1, 8)
        h1, h2 = _m3.murmur3_x64_128(data, 0)
        out = np.empty((len(hs), self.num_hashes), np.int64)
        comb = h1.copy()
        with np.errstate(over="ignore"):
            for i in range(self.num_hashes):
                out[:, i] = (comb & np.uint64(0x7FFFFFFFFFFFFFFF)).astype(
                    np.int64) % self.bit_size
                comb = comb + h2
        return out

    def contains_vec(self, h: np.ndarray) -> np.ndarray:
        """Vectorized mightContain over an array of long values."""
        p = self.probes(h)
        bits = (self.words[p >> 6] >> (p.astype(np.uint64) & np.uint64(63))
                ) & np.uint64(1)
        return bits.astype(bool).all(axis=1)

    def add(self, h: int) -> None:
        for b in self.probes(h)[0]:
            self.words[b >> 6] |= np.uint64(1) << np.uint64(b & 63)

    def __contains__(self, h: int) -> bool:
        return bool(self.contains_vec(np.asarray([h], np.uint64))[0])


def kmer_string_hash(kmer: str, do_reverse_compliment: bool, seed: int = 0) -> int:
    """Hash of one k-mer string (HashUtils.computeSequenceHashesLong with the
    whole string as the single k-mer), canonicalized if requested."""
    s = kmer
    if do_reverse_compliment:
        r = reverse_complement(s)
        if r < s:
            s = r
    codes = np.frombuffer(s.encode("ascii"), dtype=np.uint8).reshape(1, -1)
    return int(_m3.hash_kmers_128(codes, seed)[0])


class FrequencyCounts:
    """Exact-set oracle of sketch/FrequencyCounts.java."""

    def __init__(self, lines, filter_cutoff: float, offset: float,
                 remove_unique: int, no_tf: bool, range_: float,
                 do_reverse_compliment: bool, use_bloom: bool = False):
        if remove_unique < 0 or remove_unique > 2:
            raise ValueError(f"Unknown removeUnique option {remove_unique}.")
        if offset < 0.0 or offset >= 1.0:
            raise ValueError("Offset can only be between 0 and 1.0.")
        self.range = range_
        self.remove_unique = remove_unique
        self.no_tf = no_tf
        self.kmer_sizes: set[int] = set()

        it = iter(lines)
        try:
            first = next(it)
        except StopIteration:
            first = None
        # header: bloom size + repeat count
        size_bloom = 1
        if first is not None:
            parts = first.strip().split()
            size_bloom = int(parts[0])
            _ = int(parts[1])

        fraction: dict[int, float] = {}
        # strict-parity mode: guava-compatible bloom with the reference's
        # sizing (FrequencyCounts.java:137); default: exact set
        valid = (GuavaBloomFilter(size_bloom) if use_bloom and
                 remove_unique > 0 else set())
        max_value = -math.inf
        for line in it:
            parts = line.split(None, 2)
            if not parts:
                continue
            kmer = parts[0]
            self.kmer_sizes.add(len(kmer))
            h = kmer_string_hash(kmer, do_reverse_compliment)
            if len(parts) >= 2:
                percent = float(parts[1])
                if percent >= filter_cutoff:
                    max_value = max(max_value, percent)
                    fraction[h] = percent
            if remove_unique > 0:
                valid.add(h)

        self.fraction_counts = fraction
        self.valid_mers = valid if remove_unique > 0 else None
        self.filter_cutoff = filter_cutoff
        self.offset = offset
        self.max_value = max_value
        self.min_value = filter_cutoff
        self.min_idf_value = self.idf_freq(self.max_value)
        self.max_idf_value = self.idf_freq(self.min_value)

    def idf_freq(self, freq: float) -> float:
        return math.log(self.max_value / freq - self.offset)

    def document_frequency_ratio(self, h: int) -> float:
        return self.fraction_counts.get(h, self.min_value)

    def is_popular(self, h: int) -> bool:
        return h in self.fraction_counts

    def keep_kmer(self, h: int) -> bool:
        if self.remove_unique == 1:
            return h in self.valid_mers
        return True

    def max_idf(self) -> float:
        return self.max_idf_value

    def min_idf(self) -> float:
        return self.min_idf_value

    def scaled_idf(self, h: int, max_value: float | None = None) -> float:
        if max_value is None:
            max_value = self.range
        if self.remove_unique == 2 and self.valid_mers is not None and h not in self.valid_mers:
            return 1.0
        val = self.fraction_counts.get(h)
        if val is None:
            return max_value
        idf = self.idf_freq(val)
        scale = (self.max_idf() - self.min_idf()) / (max_value - 1.0)
        return 1.0 + (idf - self.min_idf()) / scale

    def tf_weight(self, weight: int) -> float:
        return 1.0 if self.no_tf else float(weight)
