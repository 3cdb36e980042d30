"""Read-set generators of the benchmark, frozen here so that later changes
to the repository's own scripts cannot move the yardstick.

Copied from ``bench.py`` at the repository's root (not imported: its
configurations import the JAX package):

* ``noisy_read``          <- ``bench._noisy_read`` (unchanged; the error
  rate is an argument instead of the module constant ``ERR`` = 0.11);
* ``placed_reads``        <- ``bench.make_reads_placed`` (the read lengths,
  their start positions and the genome are arguments, so that the
  benchmark can give every seed the same layout);
* ``repeat_seeded_genome`` <- ``bench.repeat_seeded_genome`` (the random
  generator and the copies' positions are arguments);
* ``write_filter_file``   <- ``bench.write_filter_file`` (unchanged).

``quantile_lengths`` is the benchmark's own.
"""

from __future__ import annotations

from collections import Counter
from statistics import NormalDist

import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def noisy_read(rng, raw, out_len, err=0.11):
    """Vectorized PacBio-like error channel over base-index array ``raw``
    (ins err*0.4 / del err*0.3 / sub err*0.3): emit up to ``out_len``
    bases.  Returns (base indices, #raw bases consumed)."""
    r = rng.random(len(raw))
    ins = r < err * 0.4
    dele = (r >= err * 0.4) & (r < err * 0.7)
    sub = (r >= err * 0.7) & (r < err)
    emit = np.where(dele, 0, np.where(ins, 2, 1))
    out = np.repeat(raw, emit)
    cum = np.cumsum(emit)
    # inserted random base follows the original; substitutions replace it
    rand_at = np.concatenate([cum[ins] - 1, cum[sub] - 1])
    if len(rand_at):
        out[rand_at] = rng.integers(0, 4, len(rand_at))
    consumed = int(np.searchsorted(cum, out_len) + 1)
    return out[:out_len], min(consumed, len(raw))


def quantile_lengths(n, median, sigma, lo, hi, rng):
    """``n`` read lengths: the lognormal law's quantiles at (i + 0.5) / n,
    clipped to [lo, hi], in an order drawn from ``rng``.  Every seed gets
    the same multiset of lengths, so the same number of bases."""
    z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])
    lens = np.clip(np.exp(np.log(median) + sigma * z), lo, hi).astype(int)
    return rng.permutation(lens)


def placed_reads(rng, lens, starts, genome, err=0.11):
    """Noisy reads of the given lengths from the given start positions of
    ``genome`` (base indices, at least 1.15 * max(lens) past the last
    start).  Returns (reads, placements [(start, end)])."""
    reads, placements = [], []
    for L, pos in zip(lens, starts):
        pos = int(pos)
        raw = genome[pos:pos + int(L * 1.15)]
        out, consumed = noisy_read(rng, raw, int(L), err)
        reads.append(bytes(BASES[out]).decode("ascii"))
        placements.append((pos, pos + consumed))
    return reads, placements


def repeat_seeded_genome(rng, genome_len, pad, repeat_len=2000,
                         copies=()):
    """Random genome (``genome_len`` + ``pad`` base indices) with one
    random ``repeat_len`` sequence implanted at each position of
    ``copies``; no copies gives a plain random genome."""
    genome = rng.integers(0, 4, genome_len + pad)
    repeat = rng.integers(0, 4, repeat_len)
    for pos in copies:
        genome[int(pos):int(pos) + repeat_len] = repeat
    return genome


def write_filter_file(genome, k, path, cutoff=1e-5, top=4000):
    """k-mer frequency file (sketch/FrequencyCounts.java input format:
    header 'bloomSize repeatCount', rows 'KMER fraction')."""
    bases = "ACGT"
    s = "".join(bases[int(b)] for b in genome)
    total = len(s) - k + 1
    counts = Counter(s[i:i + k] for i in range(total))
    rows = [(km, c / total) for km, c in counts.most_common(top)
            if c / total >= cutoff]
    with open(path, "w") as f:
        f.write(f"{len(rows)} {len(rows)}\n")
        for km, frac in rows:
            f.write(f"{km} {frac:.10g}\n")
    return len(rows)

