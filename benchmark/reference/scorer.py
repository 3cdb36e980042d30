"""MHAP's second-stage overlap scorer in plain Python, frozen from the
repository's oracle (``mhap_tpu_torch/oracle/scorer.py``, itself a copy of
``mhap_tpu/oracle/scorer.py``); the merge loops read Python lists rather
than NumPy scalars, which makes them several times faster and leaves the
control flow as it was.

Parity target: sketch/BottomOverlapSketch.java (getOverlapInfo :592-630,
recordMatchingKmers :397-516, MatchData :64-298, computeKBottomSketchJaccard
:304-364, jaccardToIdentity :391-395) and utils/Utils.java quickSelect
(:445-494, upper median at k = count/2).

The scorer takes two hash-sorted (hash, pos) sketch arrays and produces
(identity score, raw match count, a1, a2, b1, b2) where the coordinates are
k-mer indices clamped to [0, num_kmers].  All control flow below mirrors the
reference's sequential merge automaton, including:

  * two passes -- pass 1 with unconstrained windows, pass 2 with windows from
    pass-1 median shift +- max-shift bound;
  * duplicate-hash-run handling: on a recorded match, both cursors extend to
    the *last consecutive* entry with the same hash and a valid position
    (stopping at the first invalid entry), and if either cursor moved the
    (last1, last2) pair is also recorded with NO shift-window check;
  * shift-window failures advance only one cursor (i1 if shift too large,
    i2 if too small);
  * adjacent same-pos1 dedup keeping the shift closest to the median
    (optimizeShifts);
  * UMVU edge estimation with validCount >= 3, Java Math.round;
  * bottom-k Jaccard restricted to the estimated windows, converted to mash
    identity exp(1/k * ln(2j/(1+j))).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

EMPTY = (0.0, 0.0, 0, 0, 0, 0)


def _i32(x: int) -> int:
    """Java int wraparound (all MatchData border math is 32-bit)."""
    return ((int(x) + 2**31) % 2**32) - 2**31


@dataclass
class MatchState:
    """Mirror of BottomOverlapSketch.MatchData."""
    seq_len1: int
    seq_len2: int
    max_shift_percent: float
    pos1: list
    pos2: list
    shift: list
    median_shift: int = 0
    abs_max_shift: int = 0
    need_recompute: bool = True

    def reset(self):
        self.pos1.clear()
        self.pos2.clear()
        self.shift.clear()
        self.need_recompute = True

    def record(self, p1: int, p2: int, s: int):
        self.pos1.append(p1)
        self.pos2.append(p2)
        self.shift.append(s)
        self.need_recompute = True

    def _update(self):
        # all border arithmetic wraps in int32 like the Java reference
        # (MatchData.performUpdate + valid*(); observable for >1Gbp
        # coordinate ranges, found by the C++ differential fuzz)
        if self.need_recompute:
            count = len(self.shift)
            if count > 0:
                # quickSelect(copy, count/2, count): k-th order statistic,
                # upper median for even counts (Utils.java:445-494)
                self.median_shift = int(np.sort(np.asarray(self.shift, dtype=np.int64))[count // 2])
                left = max(0, _i32(-self.median_shift))
                right = min(self.seq_len1,
                            _i32(self.seq_len2 - self.median_shift))
                overlap_size = max(10, _i32(right - left))
                self.abs_max_shift = min(max(self.seq_len1, self.seq_len2),
                                         int(overlap_size * self.max_shift_percent))
            else:
                self.median_shift = 0
                self.abs_max_shift = _i32(max(self.seq_len1, self.seq_len2) + 1)
        self.need_recompute = False

    def get_median(self) -> int:
        self._update()
        return self.median_shift

    def get_abs_max(self) -> int:
        self._update()
        return self.abs_max_shift

    def valid1_lower(self) -> int:
        self._update()
        return max(0, _i32(-self.get_median() - self.get_abs_max()))

    def valid1_upper(self) -> int:
        self._update()
        return min(self.seq_len1,
                   _i32(self.seq_len2 - self.get_median() + self.get_abs_max()))

    def valid2_lower(self) -> int:
        self._update()
        return max(0, _i32(self.get_median() - self.get_abs_max()))

    def valid2_upper(self) -> int:
        self._update()
        return min(self.seq_len2,
                   _i32(self.seq_len1 + self.get_median() + self.get_abs_max()))

    def optimize_shifts(self):
        """Dedup adjacent same-pos1 entries (MatchData.optimizeShifts)."""
        if not self.shift:
            return
        median = self.get_median()
        rp1, rp2, rs = [], [], []
        for p1, p2, s in zip(self.pos1, self.pos2, self.shift):
            if rp1 and rp1[-1] == p1:
                if abs(rs[-1] - median) > abs(s - median):
                    rp1[-1], rp2[-1], rs[-1] = p1, p2, s
            else:
                rp1.append(p1)
                rp2.append(p2)
                rs.append(s)
        self.pos1, self.pos2, self.shift = rp1, rp2, rs
        self.need_recompute = True

    def compute_edges(self):
        """UMVU edge estimation (MatchData.computeEdges). None if <3 valid."""
        median = self.get_median()
        abs_max = self.get_abs_max()
        l1 = l2 = np.iinfo(np.int32).max
        r1 = r2 = np.iinfo(np.int32).min
        valid = 0
        for p1, p2, s in zip(self.pos1, self.pos2, self.shift):
            if abs(s - median) > abs_max:
                continue
            l1 = min(l1, p1)
            l2 = min(l2, p2)
            r1 = max(r1, p1)
            r2 = max(r2, p2)
            valid += 1
        if valid < 3:
            return None
        n = valid

        def _umvu(lo: int, hi: int) -> int:
            # Java: (int)(n*lo - hi) wraps in int32 before the double divide
            # (BottomOverlapSketch.java:131-134), then Math.round
            num = ((n * lo - hi + 2**31) % 2**32) - 2**31
            return int(math.floor(num / (n - 1) + 0.5))

        a1 = max(0, _umvu(l1, r1))
        a2 = min(self.seq_len1, _umvu(r1, l1))
        b1 = max(0, _umvu(l2, r2))
        b2 = min(self.seq_len2, _umvu(r2, l2))
        return a1, a2, b1, b2, valid


def record_matching_kmers(st: MatchState, s1: np.ndarray, s2: np.ndarray):
    """One pass of the merge automaton (recordMatchingKmers :397-516).

    s1, s2: int32 [n, 2] (hash, pos), sorted by (signed hash, pos).
    """
    median = st.get_median()
    abs_max = st.get_abs_max()
    v1l, v1u = st.valid1_lower(), st.valid1_upper()
    v2l, v2u = st.valid2_lower(), st.valid2_upper()

    n1, n2 = len(s1), len(s2)
    i1 = i2 = 0
    st.reset()

    h1c = s1[:, 0].tolist()
    p1c = s1[:, 1].tolist()
    h2c = s2[:, 0].tolist()
    p2c = s2[:, 1].tolist()

    while i1 < n1 and i2 < n2:
        hash1, pos1 = h1c[i1], p1c[i1]
        hash2, pos2 = h2c[i2], p2c[i2]

        if hash1 < hash2 or pos1 < v1l or pos1 >= v1u:
            i1 += 1
        elif hash2 < hash1 or pos2 < v2l or pos2 >= v2u:
            i2 += 1
        else:
            curr_shift = pos2 - pos1
            diff = curr_shift - median
            if diff > abs_max:
                i1 += 1
            elif diff < -abs_max:
                i2 += 1
            else:
                st.record(pos1, pos2, curr_shift)

                # extend both cursors to the last consecutive same-hash,
                # valid-position entry ("symmetry for reverse complement")
                i1_last = i1
                t = i1 + 1
                while t < n1 and h1c[t] == hash1 and v1l <= p1c[t] < v1u:
                    i1_last = t
                    t += 1
                i2_last = i2
                t = i2 + 1
                while t < n2 and h2c[t] == hash2 and v2l <= p2c[t] < v2u:
                    i2_last = t
                    t += 1

                if i1 != i1_last or i2 != i2_last:
                    p1n, p2n = p1c[i1_last], p2c[i2_last]
                    st.record(p1n, p2n, p2n - p1n)
                    i1 = i1_last + 1
                    i2 = i2_last + 1
                else:
                    i1 += 1
                    i2 += 1


def bottom_k_jaccard(s1: np.ndarray, s2: np.ndarray, a1: int, a2: int,
                     b1: int, b2: int) -> float:
    """Windowed bottom-k Jaccard (computeKBottomSketchJaccard :304-364)."""
    f1 = s1[(s1[:, 1] >= a1) & (s1[:, 1] <= a2)]
    f2 = s2[(s2[:, 1] >= b1) & (s2[:, 1] <= b2)]
    k = min(len(f1), len(f2))
    if k == 0:
        return 0.0
    i = j = inter = union = 0
    h1 = f1[:, 0].tolist()
    h2 = f2[:, 0].tolist()
    while union < k:
        if h1[i] < h2[j]:
            i += 1
        elif h1[i] > h2[j]:
            j += 1
        else:
            inter += 1
            i += 1
            j += 1
        union += 1
    return inter / k


def jaccard_to_identity(score: float, kmer_size: int) -> float:
    """mash distance -> identity (jaccardToIdentity :391-395)."""
    if score <= 0.0:
        return 0.0
    d = -1.0 / kmer_size * math.log(2.0 * score / (1.0 + score))
    return math.exp(-d)


def get_overlap_info(s1: np.ndarray, num_kmers1: int, s2: np.ndarray,
                     num_kmers2: int, kmer_size: int,
                     max_shift_percent: float,
                     identity=jaccard_to_identity) -> tuple:
    """Full stage-2 scorer (getOverlapInfo :592-630); ``identity`` turns
    the windowed Jaccard into the score.

    Returns (score, raw_score, a1, a2, b1, b2); EMPTY on rejection.
    """
    st = MatchState(num_kmers1, num_kmers2, max_shift_percent, [], [], [])

    record_matching_kmers(st, s1, s2)
    if not st.shift:
        return EMPTY
    record_matching_kmers(st, s1, s2)
    if not st.shift:
        return EMPTY
    st.optimize_shifts()
    if not st.shift:
        return EMPTY
    edges = st.compute_edges()
    if edges is None:
        return EMPTY
    a1, a2, b1, b2, valid = edges
    j = bottom_k_jaccard(s1, s2, a1, a2, b1, b2)
    score = identity(j, kmer_size)
    return (score, float(valid), a1, a2, b1, b2)
