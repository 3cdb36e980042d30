"""MHAP's k-mer filter file and tf-idf weights (reference
sketch/FrequencyCounts.java and sketch/MinHashSketch.java:95-128), for the
weight modes the benchmark's configurations run.

The file's first line is ``<bloomSize> <repeatCount>``, then one
``<kmer> <fraction>`` row a k-mer.  Each k-mer is keyed by the murmur3_128
h1 of the k-mer string, canonicalised to min(kmer, rc(kmer)) unless
``--no-rc``.  Rows with fraction >= ``--filter-threshold`` get an idf;
under ``--supress-noise`` 1 or 2 every row's key also goes into a Guava
``BloomFilter<Long>`` (MURMUR128_MITZ_64, 1e-5 false positives), as
FrequencyCounts.java:137 builds it.

Frozen from the repository's NumPy oracle
(``mhap_tpu_torch/oracle/filter.py``: ``GuavaBloomFilter``,
``FrequencyCounts``), with the per-k-mer loops made tensor operations.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .murmur3 import hash128_long, hash128_windows

_RC = str.maketrans("ACGT", "TGCA")


class BloomFilter:
    """Guava ``BloomFilter.create(longFunnel, n, fpp)``: numBits =
    (long)(-n ln p / ln(2)^2) in 64-bit words, numHashFunctions =
    max(1, round(numBits / n ln 2)); a long's probes are
    ((h1 + i h2) & Long.MAX_VALUE) mod bitSize for i < numHashFunctions."""

    def __init__(self, expected: int, fpp: float = 1e-5):
        n = max(int(expected), 1)
        bits = max(int(-n * math.log(fpp) / (math.log(2) ** 2)), 1)
        self.bit_size = (bits + 63) // 64 * 64
        self.num_hashes = max(1, round(bits / n * math.log(2)))
        self.words = torch.zeros(self.bit_size // 64, dtype=torch.int64)

    def _probes(self, keys: torch.Tensor) -> torch.Tensor:
        h1, h2 = hash128_long(keys)
        i = torch.arange(self.num_hashes, device=keys.device)
        comb = h1[:, None] + i[None, :] * h2[:, None]
        return (comb & ((1 << 63) - 1)) % self.bit_size

    def put(self, keys: torch.Tensor) -> None:
        p = self._probes(keys.cpu()).reshape(-1)
        bits = np.zeros(self.bit_size, dtype=bool)
        bits[p.numpy()] = True
        w = np.packbits(bits.reshape(-1, 64), axis=1, bitorder="little")
        self.words |= torch.from_numpy(w.copy().view("<i8").reshape(-1))

    def contains(self, keys: torch.Tensor) -> torch.Tensor:
        words = self.words.to(keys.device)
        p = self._probes(keys)
        bit = (words[p >> 6] >> (p & 63)) & 1
        return (bit == 1).all(dim=1)


def kmer_keys(kmers: list[str], canonical: bool) -> torch.Tensor:
    """murmur3_128 h1 of each k-mer string (all of one length)."""
    if canonical:
        kmers = [min(s, s.translate(_RC)[::-1]) for s in kmers]
    codes = np.frombuffer("".join(kmers).encode("ascii"), dtype=np.uint8)
    codes = torch.from_numpy(codes.reshape(len(kmers), -1).copy())
    return hash128_windows(codes, codes.shape[1])[:, 0]


class FilterFile:
    """The filter file as FrequencyCounts.java reads it, with the weight
    rule of MinHashSketch.java for ``0 <= repeat_weight < 1``."""

    def __init__(self, path: str, filter_cutoff: float, repeat_weight: float,
                 remove_unique: int, no_tf: bool, idf_range: float,
                 canonical: bool):
        if not 0.0 <= repeat_weight < 1.0:
            raise ValueError("the reference weighs by tf-idf only "
                             "(0 <= repeat_weight < 1)")
        if remove_unique not in (0, 2):
            raise ValueError("the reference runs --supress-noise 0 or 2")
        with open(path) as f:
            first = f.readline().split()
            rows = [line.split(None, 2) for line in f]
        rows = [r for r in rows if r]
        keys = kmer_keys([r[0] for r in rows], canonical)
        frac = np.array([float(r[1]) for r in rows])
        self.no_tf = no_tf
        self.bloom = None
        if remove_unique == 2:
            self.bloom = BloomFilter(int(first[0]))
            self.bloom.put(keys)
        keep = frac >= filter_cutoff
        fk = keys.numpy()[keep]
        fv = frac[keep]
        # later rows of one key overwrite earlier ones (a Java map put)
        last = {int(k): float(v) for k, v in zip(fk, fv)}
        max_value = float(fv.max()) if len(fv) else -math.inf

        def idf(freq):
            return math.log(max_value / freq - repeat_weight)

        min_idf = idf(max_value)
        max_idf = idf(filter_cutoff)
        scale = (max_idf - min_idf) / (idf_range - 1.0)
        ks = sorted(last)
        self.keys = torch.tensor(ks, dtype=torch.int64)
        self.sidf = torch.tensor(
            [1.0 + (idf(last[k]) - min_idf) / scale for k in ks] +
            [float(idf_range)], dtype=torch.float64)  # last: not in the file

    def weights(self, keys: torch.Tensor, counts: torch.Tensor):
        """max(1, round(tf * scaledIdf)) of each (k-mer, count in read),
        as two float64 operations (Java's double multiply and add)."""
        fkeys = self.keys.to(keys.device)
        sidf = self.sidf.to(keys.device)
        K = fkeys.numel()
        if K:
            i = torch.searchsorted(fkeys, keys).clamp_(max=K - 1)
            i = torch.where(fkeys[i] == keys, i, K)
        else:
            i = torch.zeros_like(keys)
        s = sidf[i]
        if self.bloom is not None:
            s = torch.where(self.bloom.contains(keys), s, 1.0)
        tf = torch.ones_like(s) if self.no_tf else counts.to(torch.float64)
        w = torch.floor(tf * s + 0.5)
        return w.clamp_(1, (1 << 31) - 1).to(torch.int64)
