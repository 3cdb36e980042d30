"""Reader of MHAP's k-mer frequency file (``-f``) at ``--supress-noise 0``.

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

``remove_unique`` 1 and 2 (``--supress-noise 1/2``) need the set of all
file k-mers (or the reference's Guava bloom filter); they are not ported
yet and raise ``NotImplementedError``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.murmur3 import kmer_hashes_128

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


class FrequencyCounts:
    """The file k-mers of a filter file as host tensors: ``keys`` int64
    [K] sorted ascending, ``sidf`` float64 [K] the scaled idf of each.
    K-mers absent from the file take ``range`` (scaledIdf's default)."""

    def __init__(self, lines, filter_cutoff: float, offset: float,
                 remove_unique: int, no_tf: bool, range_: float,
                 do_reverse_compliment: bool):
        if remove_unique < 0 or remove_unique > 2:
            raise ValueError(f"Unknown removeUnique option {remove_unique}.")
        if offset < 0.0 or offset >= 1.0:
            raise ValueError("Offset can only be between 0 and 1.0.")
        if remove_unique != 0:
            raise NotImplementedError(
                f"--supress-noise {remove_unique} needs the set of all "
                "filter-file k-mers (a Guava bloom filter in the reference) "
                "and is not ported to mhap_tpu_torch yet; only "
                "--supress-noise 0 is")
        self.range = range_
        self.no_tf = no_tf
        it = iter(lines)
        first = next(it, None)
        if first is not None:  # header: bloom size, repeat count
            parts = first.strip().split()
            int(parts[0]), int(parts[1])
        kmers, fractions = [], []
        max_value = -math.inf
        for line in it:
            parts = line.split(None, 2)
            if len(parts) < 2:
                continue
            percent = float(parts[1])
            if percent >= filter_cutoff:
                max_value = max(max_value, percent)
                kmers.append(parts[0])
                fractions.append(percent)
        keys = kmer_keys(kmers, do_reverse_compliment)
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
