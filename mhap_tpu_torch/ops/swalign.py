"""Batched affine-gap local Smith-Waterman: the plain PyTorch version of
kernel 5 (``csrc/swalign.cu``), the port of mhap_tpu/ops/swalign.py
``sw_align_batch`` (a ``jax.lax.scan`` over anti-diagonals, not a Pallas
kernel).

EstimateROC adjudicates its disputed PPV pairs with it.  Gotoh
recurrences are swept along anti-diagonals: every cell of diagonal d
depends only on diagonal d-1 (gap open/extend) and d-2 (match/mismatch),
so each step is one [P, n+1] update.  Path statistics (matches, M+I+D
columns, begin coordinates) ride through the max selections, so no
traceback is needed.  The tie rules are the JAX function's, and the
kernel keeps them:
  * E and F extend on ties: ``(E - ge) >= (H - go)``;
  * H takes diag before F before E on equal scores, and stats only where
    h > 0;
  * a fresh path begins (Q = i-1, R = j-1) where the diagonal source
    H(i-1, j-1) is 0, the boundary row and column included;
  * the best cell is the largest score, then the smallest i, then the
    smallest j (per row the earliest diagonal on strict >, then the
    first such row); a best score of 0 gives q_end = r_end = -1.
A length-L gap costs gap_open + (L-1) * gap_extend.  Bytes compare raw
(``N == N``, lower case differs from upper case); arithmetic is int32.

Here the four path statistics of each carried array are stacked as one
[4, P, n+1] tensor (M, L, Q, R), so a selection is one operation; the
values are the JAX scan's, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

I32 = torch.int32
NEG = -(1 << 29)
COLS = ("score", "q_end", "r_end", "q_begin", "r_begin", "matches",
        "errors", "length")


def pack_pairs(pairs):
    """(query, reference) byte strings -> numpy q [P, n] uint8, qlen [P]
    int32, r [P, m] uint8, rlen [P] int32, zero padded to the longest (n,
    m at least 1), as EstimateROC hands them to sw_align_batch."""
    n = max((len(a) for a, _ in pairs), default=1)
    m = max((len(b) for _, b in pairs), default=1)
    P = len(pairs)
    q = np.zeros((P, n), np.uint8)
    r = np.zeros((P, m), np.uint8)
    ql = np.zeros(P, np.int32)
    rl = np.zeros(P, np.int32)
    for i, (a, b) in enumerate(pairs):
        q[i, :len(a)] = np.frombuffer(a, np.uint8)
        r[i, :len(b)] = np.frombuffer(b, np.uint8)
        ql[i], rl[i] = len(a), len(b)
    return q, ql, r, rl


def _shift(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x moved one step along its last axis (i -> i+1), ``fill`` at 0."""
    pad = torch.full((*x.shape[:-1], 1), fill, dtype=x.dtype,
                     device=x.device)
    return torch.cat([pad, x[..., :-1]], dim=-1)


def sw_align_batch(q: torch.Tensor, qlen: torch.Tensor, r: torch.Tensor,
                   rlen: torch.Tensor, *, match: int = 2, mismatch: int = -2,
                   gap_open: int = 2, gap_extend: int = 1) -> dict:
    """q: [P, n] uint8, r: [P, m] uint8 (padded); qlen, rlen: [P] int32,
    0 <= qlen <= n, 0 <= rlen <= m.

    Returns a dict of [P] int32 tensors: score, q_end, r_end (0-based,
    inclusive), q_begin, r_begin, matches, errors, length (M+I+D columns
    of a best path)."""
    dev = q.device
    P, n = q.shape
    m = r.shape[1]
    go, ge = gap_open, gap_extend
    qlen = qlen.to(I32)
    rlen = rlen.to(I32)
    # rext[p, t] holds r[p, t - (n+1)]: diagonal d reads r[j-1] at
    # n + d - i (clamped: past the end lie only invalid cells, as in JAX)
    rext = torch.cat([torch.zeros((P, n + 1), dtype=torch.uint8, device=dev),
                      r, torch.zeros((P, 2), dtype=torch.uint8, device=dev)],
                     dim=1)
    qcol = torch.cat([torch.zeros((P, 1), dtype=torch.uint8, device=dev), q],
                     dim=1)
    ivec = torch.arange(n + 1, dtype=I32, device=dev)[None, :]
    row_ok = (ivec >= 1) & (ivec <= qlen[:, None])
    one_l = torch.tensor([0, 1, 0, 0], dtype=I32, device=dev)[:, None, None]
    z = torch.zeros((P, n + 1), dtype=I32, device=dev)
    zs = torch.zeros((4, P, n + 1), dtype=I32, device=dev)
    neg = torch.full((P, n + 1), NEG, dtype=I32, device=dev)
    H1, E1, F1, H2 = z, neg, neg, z
    hS1, hS2, eS1, fS1 = zs, zs, zs, zs
    cbest, cbd, cbS = z, z, zs
    for d in range(2, n + m + 1):
        j = d - ivec
        valid = row_ok & (j >= 1) & (j <= rlen[:, None])
        # E: gap along r, source (i, j-1) = diagonal d-1, same i
        e_ext = (E1 - ge) >= (H1 - go)
        e = torch.where(e_ext, E1 - ge, H1 - go)
        eS = torch.where(e_ext, eS1, hS1) + one_l
        # F: gap along q, source (i-1, j) = diagonal d-1 shifted in i
        H1s = _shift(H1, 0)
        F1s = _shift(F1, NEG)
        f_ext = (F1s - ge) >= (H1s - go)
        f = torch.where(f_ext, F1s - ge, H1s - go)
        fS = torch.where(f_ext, _shift(fS1, 0), _shift(hS1, 0)) + one_l
        # diag: source (i-1, j-1) = diagonal d-2 shifted in i
        H2s = _shift(H2, 0)
        rchar = torch.gather(rext, 1, (n + d - ivec).clamp(
            max=n + m + 2).long().expand(P, -1))
        is_match = (qcol == rchar).to(I32)
        diag = H2s + torch.where(is_match.bool(), match, mismatch).to(I32)
        dS = _shift(hS2, 0) + torch.stack(
            [is_match, torch.ones_like(is_match), z, z])
        # path start where the diagonal source scored 0
        dS[2:] = torch.where(H2s == 0, torch.stack(
            [(ivec - 1).expand(P, -1), (j - 1).expand(P, -1)]), dS[2:])
        h = torch.maximum(torch.maximum(diag, torch.zeros_like(diag)),
                          torch.maximum(e, f))
        h = torch.where(valid, h, 0)
        pos = h > 0
        from_diag = pos & (h == diag)
        from_f = pos & ~from_diag & (h == f)
        from_e = pos & ~from_diag & ~from_f & (h == e)
        hS = torch.where(from_diag, dS, torch.where(
            from_f, fS, torch.where(from_e, eS, zs)))
        e = torch.where(valid, e, NEG)
        f = torch.where(valid, f, NEG)
        upd = h > cbest  # strict >: the earliest diagonal of a row wins
        cbest = torch.where(upd, h, cbest)
        cbd = torch.where(upd, d, cbd)
        cbS = torch.where(upd, hS, cbS)
        H2, H1, E1, F1 = H1, h, e, f
        hS2, hS1, eS1, fS1 = hS1, hS, eS, fS
    score = cbest.max(dim=1).values
    # the first row holding the best score
    win_i = torch.where(cbest == score[:, None], ivec, n + 1).min(
        dim=1).values
    idx = win_i.long()[:, None]
    bd = torch.gather(cbd, 1, idx)[:, 0]
    M, L, Q, R = (torch.gather(cbS[k], 1, idx)[:, 0] for k in range(4))
    return {"score": score, "q_end": win_i - 1, "r_end": bd - win_i - 1,
            "q_begin": Q, "r_begin": R, "matches": M, "errors": L - M,
            "length": L}
