"""Sketch-valued AlignElements + windowed sub-sketches (the port's copy
of mhap_tpu/align/elements.py).

Parity targets: align/AlignElementSketch.java (array of sketches,
coordinate scaling by stepSize), align/AlignElementDoubleSketch.java
(overlapped double-width windows; similarityScore = max over 3 neighbor
pairings :122-132; +-1 window boundary refinement via similarityOffset
:134-159; score/100000 normalization :88),
impl/MinHashBitSequenceSubSketches.java (stepSize windows, one 1-bit
MinHash per double-width window, DP chaining via localAlignOneSkip,
binary format :107-180).  This is the reference's abandoned third stage
(SequenceSketch.java:54), kept for capability parity.
"""

from __future__ import annotations

import struct

import numpy as np

from ..sketches.bits import MinHashBitSketch
from .aligner import Aligner, AlignElement


class AlignElementSketch(AlignElement):
    """Plain sketch array element (align/AlignElementSketch.java)."""

    def __init__(self, sketches: list, step_size: int, seq_length: int):
        self.elements = sketches
        self.step_size = step_size
        self.seq_length = seq_length

    def length(self) -> int:
        return len(self.elements)

    def similarity_score(self, other, i: int, j: int) -> float:
        return self.elements[i].similarity(other.elements[j])


class AlignElementDoubleSketch(AlignElement):
    def __init__(self, sketches: list, step_size: int, seq_length: int):
        self.elements = sketches
        self.step_size = step_size
        self.seq_length = seq_length

    def length(self) -> int:
        n = len(self.elements) // 2
        if len(self.elements) % 2:
            n += 1
        return n

    def similarity_score(self, other, i: int, j: int) -> float:
        m = self.elements[2 * i].similarity(other.elements[2 * j])
        if 2 * i + 1 < len(self.elements):
            m = max(m, self.elements[2 * i + 1].similarity(other.elements[2 * j]))
        if 2 * j + 1 < len(other.elements):
            m = max(m, self.elements[2 * i].similarity(other.elements[2 * j + 1]))
        return m

    def _similarity_offset(self, other, i: int, j: int) -> int:
        m = self.elements[2 * i].similarity(other.elements[2 * j])
        diff = 0
        if 2 * i + 1 < len(self.elements):
            v = self.elements[2 * i + 1].similarity(other.elements[2 * j])
            if m < v:
                m, diff = v, 1
        if 2 * j + 1 < len(other.elements):
            v = self.elements[2 * i].similarity(other.elements[2 * j + 1])
            if m < v:
                m, diff = v, -1
        return diff

    def get_overlap_info(self, aligner: Aligner, other):
        """(score, rawScore, a1, a2, b1, b2) tuple
        (AlignElementDoubleSketch.getOverlapInfo :46-89)."""
        al = aligner.local_align_one_skip(self, other)
        a1, a2 = al.a1 * 2, al.a2 * 2
        b1, b2 = al.b1 * 2, al.b2 * 2
        if al.score < 0.0:
            return (0.0, 0.0, a1, a2, b1, b2)
        off_s = self._similarity_offset(other, al.a1, al.b1)
        off_e = self._similarity_offset(other, al.a2, al.b2)
        if off_s > 0:
            a1 += 1
        elif off_s < 0:
            b1 += 1
        if off_e > 0:
            a2 += 1
        elif off_e < 0:
            b2 += 1
        a1 *= self.step_size
        a2 = min(self.seq_length - 1, a2 * self.step_size + self.step_size - 1)
        b1 *= other.step_size
        b2 = min(other.seq_length - 1,
                 b2 * other.step_size + other.step_size - 1)
        return (al.score / 100000.0, al.score, a1, a2, b1, b2)


class MinHashBitSequenceSubSketches:
    """Windowed 1-bit MinHash sub-sketches + DP overlap estimation."""

    def __init__(self, seq: str, kmer_size: int, step_size: int,
                 num_words: int):
        sketches = self.compute_sequences_double(seq, kmer_size, step_size,
                                                 num_words)
        self.alignment_sketch = AlignElementDoubleSketch(
            sketches, step_size, len(seq))

    @staticmethod
    def compute_sequences_double(seq: str, ngram: int, step: int,
                                 num_words: int) -> list:
        """Double-width overlapped windows (:74-100)."""
        remainder = len(seq) % step
        num = (len(seq) - remainder) // step - 1
        if remainder >= step // 2 and remainder >= ngram:
            num += 1
        out = []
        start = 0
        for _ in range(num):
            end = min(len(seq), start + step * 2)
            cur = max(0, end - step * 2)
            out.append(MinHashBitSketch(seq[cur:end], ngram, num_words))
            start += step
        return out

    @staticmethod
    def compute_sequences(seq: str, ngram: int, step: int,
                          num_words: int) -> list:
        """Single-width windows (:45-72)."""
        remainder = len(seq) % step
        num = (len(seq) - remainder) // step
        if remainder > 0:
            num += 1
        out = []
        start = 0
        for _ in range(num):
            end = min(len(seq), start + step)
            cur = max(0, end - step)
            out.append(MinHashBitSketch(seq[cur:end], ngram, num_words))
            start += step
        return out

    def get_overlap_info(self, aligner: Aligner, other):
        return self.alignment_sketch.get_overlap_info(
            aligner, other.alignment_sketch)

    def to_bytes(self) -> bytes:
        """Binary format (:107-180): big-endian counts + words."""
        el = self.alignment_sketch
        nw = len(el.elements[0].bits)
        out = struct.pack(">iiii", len(el.elements), nw, el.step_size,
                          el.seq_length)
        for sk in el.elements:
            out += sk.bits.astype(">u8").tobytes()
        return out

    @classmethod
    def from_bytes(cls, data: bytes):
        ns, nw, step, seq_len = struct.unpack_from(">iiii", data, 0)
        obj = cls.__new__(cls)
        sketches = []
        off = 16
        for _ in range(ns):
            bits = np.frombuffer(data, dtype=">u8", count=nw,
                                 offset=off).astype(np.uint64)
            sketches.append(MinHashBitSketch(bits))
            off += 8 * nw
        obj.alignment_sketch = AlignElementDoubleSketch(sketches, step, seq_len)
        return obj
