"""Generic local DP alignment over AlignElements (the port's copy of
mhap_tpu/align/aligner.py).

Parity target: align/Aligner.java -- ``local_align_smith_water_gotoh``
(Gotoh affine-gap local SW with D/P/Q matrices + traceback, :135-224) and
``local_align_one_skip`` (free end-skips on the last row/column, used for
window-sketch chaining, :226-340); align/Alignment.java (op list, score,
``get_overlap_score`` mean-similarity with min-match gate, :66-136);
align/AlignElement*.java element types.

All DP runs in float32 like the Java reference (`float[][]`).  The numpy
row loop mirrors the Java loop order so tie-breaks match exactly.  The
batched device equivalent for plain sequences is kernel 5
(ops/swalign_kernels.py).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np

NEG_INF = np.float32(-np.inf)


class Operation(enum.Enum):
    MATCH = 0
    INSERT = 1
    DELETE = 2


class AlignElement:
    """Interface (align/AlignElement.java): length + pairwise similarity."""

    def length(self) -> int:
        raise NotImplementedError

    def similarity_score(self, other, i: int, j: int) -> float:
        raise NotImplementedError


class AlignElementString(AlignElement):
    """Characters; match=+1 / mismatch=-1 (align/AlignElementString.java)."""

    def __init__(self, s: str):
        self.s = s

    def length(self) -> int:
        return len(self.s)

    def similarity_score(self, other: "AlignElementString", i, j) -> float:
        return 1.0 if self.s[i] == other.s[j] else -1.0

    def similarity_matrix(self, other: "AlignElementString") -> np.ndarray:
        a = np.frombuffer(self.s.encode(), np.uint8)
        b = np.frombuffer(other.s.encode(), np.uint8)
        return np.where(a[:, None] == b[None, :], np.float32(1.0),
                        np.float32(-1.0))


@dataclass
class Alignment:
    a: AlignElement
    b: AlignElement
    a1: int
    a2: int
    b1: int
    b2: int
    score: float
    operations: list | None

    def get_overlap_score(self, min_matches: int) -> float:
        """Mean similarity over matched ops (Alignment.java:66-136)."""
        ops = self.operations
        if not ops:
            return 0.0
        t = 0
        i = j = 0
        n = len(ops)
        # strip leading deletes, then (if none) leading inserts
        while t < n and ops[t] == Operation.DELETE:
            i += 1
            t += 1
        if t >= n:
            return 0.0
        if i == 0:
            while t < n and ops[t] == Operation.INSERT:
                t += 1
            if t >= n:
                return 0.0
        score = 0.0
        count = 0
        while t < n:
            o = ops[t]
            if o == Operation.DELETE:
                i += 1
            elif o == Operation.INSERT:
                j += 1
            else:
                score += self.a.similarity_score(self.b, i, j)
                count += 1
                i += 1
                j += 1
            t += 1
        if count < min_matches or score <= 0.0:
            return 0.0
        return score / count


def _sim_matrix(a: AlignElement, b: AlignElement) -> np.ndarray:
    if hasattr(a, "similarity_matrix"):
        return np.asarray(a.similarity_matrix(b), np.float32)
    n, m = a.length(), b.length()
    out = np.empty((n, m), np.float32)
    for i in range(n):
        for j in range(m):
            out[i, j] = a.similarity_score(b, i, j)
    return out


class Aligner:
    def __init__(self, store_path: bool, gap_open: float, gap_extend: float,
                 score_offset: float = 0.0):
        self.gap_open = np.float32(gap_open)
        self.gap_extend = np.float32(gap_extend)
        self.store_path = store_path
        self.score_offset = np.float32(score_offset)

    def local_align_smith_water_gotoh(self, a, b) -> Alignment:
        n, m = a.length(), b.length()
        sim = _sim_matrix(a, b) + self.score_offset
        D = np.zeros((n + 1, m + 1), np.float32)
        P = np.zeros((n + 1, m + 1), np.float32)
        Q = np.zeros((n + 1, m + 1), np.float32)
        P[1:, 0] = NEG_INF
        Q[1:, 0] = NEG_INF
        P[0, 1:] = NEG_INF
        Q[0, 1:] = NEG_INF

        go, ge = self.gap_open, self.gap_extend
        # row-wise vectorized in i; Q needs a j-scan per row
        max_value = np.float32(0.0)
        max_i = max_j = 0
        for i in range(1, n + 1):
            P[i, 1:] = np.maximum(D[i - 1, 1:] + go, P[i - 1, 1:] + ge)
            q_prev = Q[i, 0]
            d_row = D[i - 1, :-1] + sim[i - 1]
            for j in range(1, m + 1):
                q_prev = max(D[i, j - 1] + go, q_prev + ge)
                Q[i, j] = q_prev
                v = max(d_row[j - 1], P[i, j], q_prev)
                D[i, j] = v
                if v > max_value:
                    max_value, max_i, max_j = v, i, j
        score = float(max_value)
        a1, b1 = 0, 0
        a2, b2 = max(0, max_i - 1), max(0, max_j - 1)

        if not self.store_path:
            return Alignment(a, b, a1, a2, b1, b2, score, None)

        ops = []
        i, j = max_i, max_j
        while i > 0 and j > 0:
            if (P[i, j] >= Q[i, j] and P[i, j] == D[i, j]) or j == 0:
                ops.append(Operation.DELETE)
                i -= 1
            elif Q[i, j] == D[i, j] or i == 0:
                ops.append(Operation.INSERT)
                j -= 1
            else:
                ops.append(Operation.MATCH)
                i -= 1
                j -= 1
        a1, b1 = i, j
        while i > 0:
            ops.append(Operation.DELETE)
            i -= 1
        ops.reverse()
        return Alignment(a, b, a1, a2, b1, b2, score, ops)

    def local_align_one_skip(self, a, b) -> Alignment:
        """Free end-skips on last row/column (Aligner.java:226-340)."""
        n, m = a.length(), b.length()
        sim = _sim_matrix(a, b) + self.score_offset
        D = np.zeros((n + 1, m + 1), np.float32)
        P = np.zeros((n + 1, m + 1), np.float32)
        S = np.zeros((n + 1, m + 1), np.float32)
        go = self.gap_open

        max_value = np.float32(0.0)
        max_i = max_j = 0
        for i in range(1, n + 1):
            for j in range(1, m + 1):
                P[i, j] = max(D[i - 1, j] + go, D[i, j - 1] + go)
                D[i, j] = S[i - 1, j - 1] + sim[i - 1, j - 1]
                s = max(P[i, j], D[i, j])
                if i == n:
                    s = max(s, S[i, j - 1])
                if j == m:
                    s = max(s, S[i - 1, j])
                S[i, j] = s
                if s > max_value and (i == n or j == m):
                    max_value, max_i, max_j = s, i, j
        score = float(max_value)
        a2, b2 = max(0, max_i - 1), max(0, max_j - 1)

        if self.store_path:
            ops = []
            i, j = max_i, max_j
            while i > 0 and j > 0:
                if S[i, j] == D[i - 1, j] + go:
                    ops.append(Operation.DELETE)
                    i -= 1
                elif S[i, j] == D[i, j - 1] + go:
                    ops.append(Operation.INSERT)
                    j -= 1
                else:
                    ops.append(Operation.MATCH)
                    i -= 1
                    j -= 1
            a1, b1 = i, j
            while i > 0:
                ops.append(Operation.DELETE)
                i -= 1
            while j > 0:
                ops.append(Operation.INSERT)
                j -= 1
            ops.reverse()
            return Alignment(a, b, a1, a2, b1, b2, score, ops)

        i, j = max_i, max_j
        while i > 0 and j > 0:
            if S[i - 1, j] > S[i, j - 1] and S[i - 1, j] > S[i - 1, j - 1]:
                i -= 1
            elif S[i, j - 1] > S[i - 1, j - 1]:
                j -= 1
            else:
                i -= 1
                j -= 1
        return Alignment(a, b, i, a2, j, b2, score, None)
