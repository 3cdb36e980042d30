"""Counting sketches (secondary layer; reference dead code kept for
capability parity; the port's copy of mhap_tpu/sketches/counters.py).

Parity targets: sketch/CountMin.java (count-min with k-wise murmur3_32
object hashing via HashUtils.computeHashesInt, non-negative index =
``(h << 1) >>> 1 % width``), sketch/ClassicCounter.java (exact counter
map), sketch/Counter.java / Filter.java interfaces.
"""

from __future__ import annotations

import math
from collections import defaultdict

import numpy as np

from ..utils import native


def compute_hashes_int(obj, num_words: int, seed: int) -> np.ndarray:
    """k-wise murmur3_32 hashing of an object (HashUtils.computeHashesInt
    :65-159): hash i uses seed seed+i over the object's byte encoding."""
    if isinstance(obj, str):
        data = obj.encode("utf-16-le")
    elif isinstance(obj, int):
        data = int(obj).to_bytes(8, "little", signed=True)
    elif isinstance(obj, bytes):
        data = obj
    else:
        raise TypeError(f"unhashable object type {type(obj)}")
    out = np.empty(num_words, np.int32)
    for w in range(num_words):
        out[w] = np.int32(np.uint32(native.murmur3_x86_32(data, seed + w)))
    return out


class CountMin:
    """Count-min sketch (sketch/CountMin.java)."""

    def __init__(self, depth: int = None, width: int = None, seed: int = 0,
                 eps: float = None, confidence: float = None):
        if eps is not None:
            depth = int(math.ceil(-math.log(1.0 - confidence) / math.log(2)))
            width = int(math.ceil(2.0 / eps))
        self.depth = depth
        self.width = width
        self.seed = seed
        self.table = np.zeros((depth, width), np.int64)
        self.total_added = 0

    def _indexes(self, obj) -> np.ndarray:
        h = compute_hashes_int(obj, self.depth, self.seed)
        # Java: ((h << 1) >>> 1) % width  (clear sign bit)
        nonneg = (h.astype(np.int64) << 1) & 0xFFFFFFFF
        nonneg >>= 1
        return (nonneg % self.width).astype(np.int64)

    def add(self, obj, increment: int = 1) -> None:
        if increment <= 0:
            raise ValueError("Positive value expected for increment.")
        idx = self._indexes(obj)
        self.table[np.arange(self.depth), idx] += increment
        self.total_added += increment

    def get_count(self, obj) -> int:
        idx = self._indexes(obj)
        return int(self.table[np.arange(self.depth), idx].min())


class ClassicCounter:
    """Exact counter map (sketch/ClassicCounter.java)."""

    def __init__(self):
        self.counts = defaultdict(int)
        self.max_count = 0
        self.total = 0

    def add(self, obj, increment: int = 1) -> None:
        self.counts[obj] += increment
        self.total += increment
        if self.counts[obj] > self.max_count:
            self.max_count = self.counts[obj]

    def get_count(self, obj) -> int:
        return self.counts.get(obj, 0)
