"""One candidate pair through MHAP's second-stage scorer and, above the
threshold, its M4 line (impl/MatchResult.java:98-113).  NumPy and Python
only, so that the check's worker processes load no more than this.

``identity64`` is the configuration's float64 identity, as Java computes
it; ``identity32`` the same in float32, the control that a lower
precision has to fail.
"""

from __future__ import annotations

import numpy as np

from . import scorer


def identity64(j: float, k: int) -> float:
    return scorer.jaccard_to_identity(j, k)


def identity32(j: float, k: int) -> np.float32:
    """jaccardToIdentity in float32 arithmetic."""
    if j <= 0.0:
        return np.float32(0.0)
    j = np.float32(j)
    d = np.float32(-1.0) / np.float32(k) * np.log(
        np.float32(2.0) * j / (np.float32(1.0) + j))
    return np.exp(-d)


def score_line(task):
    """One candidate pair through the scorer and MatchResult's format:
    the line, or None under the threshold."""
    (q, c, cfg, f32) = task
    (q_ord, q_nk, q_len, q_fwd, q_shown) = q
    (c_ord, c_nk, c_len, c_fwd, c_shown) = c
    ident = identity32 if f32 else identity64
    score, raw, a1, a2, b1, b2 = scorer.get_overlap_info(
        q_ord, q_nk, c_ord, c_nk, cfg["ordered_kmer_size"],
        cfg["max_shift"], ident)
    if score < cfg["threshold"]:
        return None
    fa1, fa2 = (a1, a2) if q_fwd else (q_len - a2 - 1, q_len - a1 - 1)
    fb1, fb2 = (b1, b2) if c_fwd else (c_len - b2 - 1, c_len - b1 - 1)
    if f32:
        err = float(np.float32(1.0) - np.minimum(score, np.float32(1.0)))
    else:
        err = 1.0 - min(score, 1.0)
    return "%s %s %.6f %.6f %d %d %d %d %d %d %d %d" % (
        q_shown, c_shown, err, raw, 0 if q_fwd else 1, fa1, fa2, q_len,
        0 if c_fwd else 1, fb1, fb2, c_len)
