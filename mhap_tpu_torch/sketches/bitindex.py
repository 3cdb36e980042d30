"""Generic LSH index over bit sketches (the port's copy of
mhap_tpu/sketches/bitindex.py).

Parity target: sketch/BitVectorIndex.java -- numIndexes random b-bit
projections (b=10), numIndexes from the confidence formula
ceil(log(1-confidence)/log(1-minSimilarity^b)) (:56-62), candidate union
+ exact similarity rescore in getNeighbors (:129-165).  The reference
seeds its bit choices from MersenneTwisterFast with a time-derived seed;
here the RNG is an explicit argument (deterministic by default).

This is the conceptual template of the banded main-path LSH.  The
rescore is the exact per-pair ``BitSketch.similarity`` on the host, as
in the JAX package: the float32 ``bit_similarity_matrix`` could move a
pair across ``min_similarity``.
"""

from __future__ import annotations

import math

import numpy as np

from .bits import BitSketch


class BitVectorIndex:
    def __init__(self, value_pairs, min_similarity: float,
                 confidence: float, b: int = 10, rng=None):
        self.min_similarity = min_similarity
        num_indexes = int(math.ceil(
            math.log(1.0 - confidence)
            / math.log(1.0 - min_similarity ** b)))
        rng = rng or np.random.default_rng(0)
        self.pairs = list(value_pairs)
        num_bits = self.pairs[0][1].number_of_bits() if self.pairs else 1
        self.bits_used = np.stack(
            [rng.choice(num_bits, size=b, replace=False)
             for _ in range(num_indexes)])
        self.tables: list[dict[int, list[int]]] = [
            {} for _ in range(num_indexes)]
        for pid, (key, sketch) in enumerate(self.pairs):
            for t, bits in enumerate(self.bits_used):
                sig = self._signature(sketch, bits)
                self.tables[t].setdefault(sig, []).append(pid)

    @staticmethod
    def _signature(sketch: BitSketch, bits) -> int:
        sig = 0
        for bit in bits:
            sig = (sig << 1) | int(sketch.get_bit(int(bit)))
        return sig

    def get_neighbors(self, sketch: BitSketch) -> list:
        cands = set()
        for t, bits in enumerate(self.bits_used):
            sig = self._signature(sketch, bits)
            cands.update(self.tables[t].get(sig, ()))
        out = []
        for pid in cands:
            key, cand = self.pairs[pid]
            if cand.similarity(sketch) >= self.min_similarity:
                out.append(key)
        return out
