"""Reader of MHAP's k-mer frequency file (``-f``).

Parity target: sketch/FrequencyCounts.java:100-186, 290-311 (the JAX
package's counterpart is mhap_tpu/oracle/filter.py).  The first line is
``<bloomSize> <repeatCount>``; every further line is ``<kmer>
<fraction> ...``.  A k-mer whose fraction is at least ``filter_cutoff``
is a file k-mer: it is keyed by the murmur3_128 h1 of the k-mer string,
canonicalised first (the reverse complement when that is the smaller
string) unless reverse complements are off.  A k-mer listed twice keeps
the fraction of its last line; ``max_value`` is the largest fraction at
or above the cutoff.

Each file k-mer's scaled idf is computed once, on the host, with scalar
``math.log`` in float64 (Java double), so the tf-idf weights built from
it (pipeline/freqfilter.py) are bit-equal to the reference's.

``remove_unique`` 1 and 2 (``--supress-noise 1/2``) also keep the set of
every k-mer line of the file, whatever its fraction, keyed the same way
(FrequencyCounts.java:137, :189-193): mode 1 drops a k-mer outside it,
mode 2 gives such a k-mer the scaled idf 1.0.  The set is exact (a sorted
key tensor) by default; ``use_bloom=True`` builds the reference's Guava
``BloomFilter<Long>`` instead (``GuavaBloomFilter``, bit-compatible, sized
from the file's first line at 1e-5 false positives), as the CLI does for
runs comparable with the reference jar.
"""

from __future__ import annotations

import copy
import math

import numpy as np
import torch

from ..ops.murmur3 import kmer_hashes_128, murmur3_128_long

# utils/Utils.java rc(): IUPAC complement, unknown characters unchanged
_COMPLEMENT = dict(zip("ABCDGHKMNRSTVWY", "TVGHCDMKNYSABWR"))
_RC_TABLE = np.array([ord(_COMPLEMENT.get(chr(c), chr(c)))
                      for c in range(256)], np.uint8)


def canonical_rows(kmers: np.ndarray) -> np.ndarray:
    """[N, k] uint8 k-mers -> each row or its reverse complement,
    whichever is the smaller string (oracle/filter.py:88-92)."""
    rc = _RC_TABLE[kmers[:, ::-1]]
    diff = kmers != rc
    first = diff.argmax(axis=1)
    rows = np.arange(len(kmers))
    use_rc = diff.any(axis=1) & (rc[rows, first] < kmers[rows, first])
    return np.where(use_rc[:, None], rc, kmers)


def kmer_keys(kmers: list[str], canonical: bool) -> np.ndarray:
    """murmur3_128 h1 of each k-mer string (int64), one batched hash per
    k-mer length."""
    keys = np.zeros(len(kmers), np.int64)
    by_len: dict[int, list[int]] = {}
    for i, s in enumerate(kmers):
        by_len.setdefault(len(s), []).append(i)
    for k, idx in by_len.items():
        rows = np.frombuffer("".join(kmers[i] for i in idx).encode("ascii"),
                             np.uint8).reshape(len(idx), k)
        if canonical:
            rows = canonical_rows(rows)
        h = kmer_hashes_128(torch.tensor(rows), k)
        keys[idx] = h[:, 0].numpy()
    return keys


class GuavaBloomFilter:
    """Guava's ``BloomFilter.create(longFunnel, n, fpp)`` with strategy
    MURMUR128_MITZ_64, bit for bit (mhap_tpu/oracle/filter.py
    GuavaBloomFilter): numBits = (long)(-n ln(fpp) / ln(2)^2), held in
    64-bit words; numHashFunctions = max(1, round(numBits / n * ln 2)).
    A key's probes are ``(h1 + i * h2) & Long.MAX_VALUE mod bitSize`` for
    i < numHashFunctions, (h1, h2) the murmur3_128 of its 8 little-endian
    bytes (ops/murmur3.murmur3_128_long).  ``words`` is an int64 tensor;
    ``to`` copies the filter to a device, where ``contains`` runs as
    tensor gathers."""

    def __init__(self, expected_insertions: int, fpp: float = 1e-5):
        n = max(int(expected_insertions), 1)
        num_bits = max(int(-n * math.log(fpp) / (math.log(2) ** 2)), 1)
        self.bit_size = ((num_bits + 63) // 64) * 64
        self.num_hashes = max(1, round(num_bits / n * math.log(2)))
        self.words = torch.zeros(self.bit_size // 64, dtype=torch.int64)

    def to(self, device) -> "GuavaBloomFilter":
        out = copy.copy(self)
        out.words = self.words.to(device)
        return out

    def _probes(self, keys: torch.Tensor):
        """The probed bit index of every key, one tensor per hash."""
        h1, h2 = murmur3_128_long(keys)
        comb = h1
        for _ in range(self.num_hashes):
            yield (comb & ((1 << 63) - 1)) % self.bit_size
            comb = comb + h2

    def add(self, keys: torch.Tensor) -> None:
        """Sets the probed bits of int64 keys (host tensors)."""
        words = self.words.numpy().view(np.uint64)
        for p in self._probes(keys.reshape(-1)):
            p = p.numpy()
            np.bitwise_or.at(words, p >> 6,
                             np.left_shift(np.uint64(1),
                                           (p & 63).astype(np.uint64)))

    def contains(self, keys: torch.Tensor) -> torch.Tensor:
        """mightContain of each int64 key, on the words' device."""
        out = torch.ones(keys.shape, dtype=torch.bool, device=keys.device)
        for p in self._probes(keys):
            out &= ((self.words[p >> 6] >> (p & 63)) & 1).bool()
        return out


class FrequencyCounts:
    """The file k-mers of a filter file as host tensors: ``keys`` int64
    [K] sorted ascending, ``sidf`` float64 [K] the scaled idf of each.
    K-mers absent from the file take ``range`` (scaledIdf's default).
    ``valid``: None at remove_unique 0; else the set of every k-mer line,
    a ``GuavaBloomFilter`` (use_bloom) or a sorted int64 key tensor."""

    def __init__(self, lines, filter_cutoff: float, offset: float,
                 remove_unique: int, no_tf: bool, range_: float,
                 do_reverse_compliment: bool, use_bloom: bool = False):
        if remove_unique < 0 or remove_unique > 2:
            raise ValueError(f"Unknown removeUnique option {remove_unique}.")
        if offset < 0.0 or offset >= 1.0:
            raise ValueError("Offset can only be between 0 and 1.0.")
        self.range = range_
        self.no_tf = no_tf
        self.remove_unique = remove_unique
        it = iter(lines)
        first = next(it, None)
        size_bloom = 1
        if first is not None:  # header: bloom size, repeat count
            parts = first.strip().split()
            size_bloom, _ = int(parts[0]), int(parts[1])
        kmers, listed, fractions = [], [], []
        max_value = -math.inf
        for line in it:
            parts = line.split(None, 2)
            if not parts:
                continue
            percent = float(parts[1]) if len(parts) >= 2 else None
            is_file_kmer = percent is not None and percent >= filter_cutoff
            if remove_unique or is_file_kmer:  # hash only what is kept
                kmers.append(parts[0])
            if is_file_kmer:
                max_value = max(max_value, percent)
                listed.append(len(kmers) - 1)
                fractions.append(percent)
        all_keys = kmer_keys(kmers, do_reverse_compliment)
        self.valid = None
        if remove_unique and use_bloom:
            self.valid = GuavaBloomFilter(size_bloom)
            self.valid.add(torch.from_numpy(all_keys))
        elif remove_unique:
            self.valid = torch.unique(torch.from_numpy(all_keys))
        keys = all_keys[np.asarray(listed, np.int64)]
        # a key listed again keeps its last fraction (a map put)
        uniq, last_rev = np.unique(keys[::-1], return_index=True)
        last = len(keys) - 1 - last_rev
        self.max_value = max_value

        def idf_freq(freq: float) -> float:
            return math.log(max_value / freq - offset)

        min_idf = idf_freq(max_value)
        max_idf = idf_freq(filter_cutoff)
        sidf = []
        if len(last):
            scale = (max_idf - min_idf) / (range_ - 1.0)
            for j in last.tolist():
                sidf.append(1.0 + (idf_freq(fractions[j]) - min_idf) / scale)
        self.keys = torch.from_numpy(uniq.astype(np.int64))
        self.sidf = torch.tensor(sidf, dtype=torch.float64)

    def __len__(self) -> int:
        return len(self.keys)
