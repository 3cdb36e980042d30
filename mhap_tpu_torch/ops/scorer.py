"""Stage-2 pair scorer, plain PyTorch version (counterpart of
mhap_tpu/ops/scorer.py and the plain version of the CUDA kernel in
``scorer_kernels.py``).

Parity target: sketch/BottomOverlapSketch.java getOverlapInfo (:592-630),
as native/scorer.h runs it: two recordMatchingKmers passes, optimizeShifts,
UMVU edges, windowed bottom-k Jaccard.  The sequential automaton is
vectorised across lanes with per-lane cursors, the way
``make_score_pairs`` (mhap_tpu/ops/scorer.py:357) vectorises it in JAX:
a shared-hash prefilter first (entries whose hash the other sketch lacks
are only ever skipped, and same-hash runs stay contiguous), then one loop
step per cursor move of the slowest lane.

Output: int32 [T, 16] columns ``COLS``.  Lanes that do not score
(ok = 0) run every stage with the empty-record median 0x7FFFFFFF, so all
columns equal the TPU kernel's (``score_pairs_pallas``) on every lane it
did not escalate; ``escal`` is always 0 here.  Identity is computed later
on the host from (inter, k).  All arithmetic is int64 with Java's int32
wraps made explicit (``_w32``).
"""

from __future__ import annotations

import torch

COLS = ("ok", "inter", "k", "valid_cnt", "a1", "a2", "b1", "b2", "escal",
        "cnt1", "cnt2", "cnt3", "n_shared")
N_COLS = 16
_IMAX = 0x7FFFFFFF
I64 = torch.int64


def _w32(x: torch.Tensor) -> torch.Tensor:
    """Java int wraparound of int64 values."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _abs_max(median, nk1, nk2, max_shift: float):
    """absMaxShiftInOverlap (MatchData.performUpdate)."""
    left = torch.clamp(_w32(-median), min=0)
    right = torch.minimum(nk1, _w32(nk2 - median))
    overlap = torch.clamp(_w32(right - left), min=10)
    prod = (overlap.to(torch.float64) * max_shift).to(I64)  # trunc, >= 0
    return torch.minimum(torch.maximum(nk1, nk2), prod)


def _windows(med, am, nk1, nk2):
    return (torch.clamp(_w32(-med - am), min=0),
            torch.minimum(nk1, _w32(nk2 - med + am)),
            torch.clamp(_w32(med - am), min=0),
            torch.minimum(nk2, _w32(nk1 + med + am)))


def _compact(h, p, keep):
    """Stable per-row compaction of (h, p) to the kept entries; the rest
    is PAD.  Returns (h, p, count)."""
    T, C = h.shape
    dst = torch.where(keep, torch.cumsum(keep.to(I64), 1) - 1, C)
    oh = torch.full((T, C + 1), _IMAX, dtype=I64, device=h.device)
    op = torch.full((T, C + 1), _IMAX, dtype=I64, device=h.device)
    oh.scatter_(1, dst, h)
    op.scatter_(1, dst, p)
    return oh[:, :C], op[:, :C], keep.sum(1)


def _run_end(h, p, n, lo, hi):
    """ext[t]: last index of the run of equal hashes with in-window
    positions that continues from t (the cursor extension target)."""
    T, C = h.shape
    col = torch.arange(C, device=h.device)
    ok = (p >= lo[:, None]) & (p < hi[:, None]) & (col[None, :] < n[:, None])
    cont = torch.zeros_like(ok)
    cont[:, :-1] = (h[:, 1:] == h[:, :-1]) & ok[:, 1:]
    stop = torch.where(cont, C - 1, col[None, :].expand(T, C))
    return torch.flip(torch.cummin(torch.flip(stop, [1]), 1).values, [1])


def _merge_pass(ah, ap, n1, bh, bp, n2, med, am, win):
    """One recordMatchingKmers pass, all lanes at once.  Returns records
    (r1, r2) [T, 2S+1] (0x7FFFFFFF past the count) and the count."""
    T, S = ah.shape
    v1l, v1u, v2l, v2u = win
    e_a = _run_end(ah, ap, n1, v1l, v1u)
    e_b = _run_end(bh, bp, n2, v2l, v2u)
    cap = 2 * S
    r1 = torch.full((T, cap + 1), _IMAX, dtype=I64, device=ah.device)
    r2 = torch.full_like(r1, _IMAX)
    i1 = torch.zeros(T, dtype=I64, device=ah.device)
    i2 = torch.zeros_like(i1)
    cnt = torch.zeros_like(i1)
    live = (i1 < n1) & (i2 < n2)
    while bool(live.any()):
        c1 = torch.clamp(i1, max=S - 1)[:, None]
        c2 = torch.clamp(i2, max=S - 1)[:, None]
        h1, p1 = ah.gather(1, c1)[:, 0], ap.gather(1, c1)[:, 0]
        h2, p2 = bh.gather(1, c2)[:, 0], bp.gather(1, c2)[:, 0]
        adv1 = (h1 < h2) | (p1 < v1l) | (p1 >= v1u)
        adv2 = ~adv1 & ((h2 < h1) | (p2 < v2l) | (p2 >= v2u))
        diff = (p2 - p1) - med
        m = ~adv1 & ~adv2
        sf1 = m & (diff > am)
        sf2 = m & (diff < -am)
        rec = live & m & ~sf1 & ~sf2
        x1 = e_a.gather(1, c1)[:, 0]
        x2 = e_b.gather(1, c2)[:, 0]
        moved = rec & ((x1 != i1) | (x2 != i2))
        r1.scatter_(1, torch.where(rec, cnt, cap)[:, None], p1[:, None])
        r2.scatter_(1, torch.where(rec, cnt, cap)[:, None], p2[:, None])
        nxt = torch.where(moved, cnt + 1, cap)[:, None]
        r1.scatter_(1, nxt, ap.gather(1, x1[:, None]))
        r2.scatter_(1, nxt, bp.gather(1, x2[:, None]))
        cnt = cnt + rec.to(I64) + moved.to(I64)
        i1 = torch.where(rec, x1 + 1,
                         i1 + (live & (adv1 | sf1)).to(I64))
        i2 = torch.where(rec, x2 + 1,
                         i2 + (live & (adv2 | sf2)).to(I64))
        live = (i1 < n1) & (i2 < n2)
    r1[:, cap] = _IMAX
    r2[:, cap] = _IMAX
    return r1, r2, cnt


def _median(r1, r2, cnt):
    """Upper median (Utils.quickSelect at count/2) of the first ``cnt``
    record shifts; 0x7FFFFFFF for an empty record set."""
    col = torch.arange(r1.shape[1], device=r1.device)
    s = torch.where(col[None, :] < cnt[:, None], r2 - r1, _IMAX)
    s = torch.sort(s, 1).values
    idx = torch.clamp(cnt // 2, max=r1.shape[1] - 1)[:, None]
    return torch.where(cnt > 0, s.gather(1, idx)[:, 0], _IMAX)


def _optimize_shifts(r1, r2, cnt, med):
    """optimizeShifts: per run of adjacent equal pos1, keep the first
    record with the least |shift - median|.  Returns compacted records."""
    T, C = r1.shape
    col = torch.arange(C, device=r1.device)[None, :]
    inr = col < cnt[:, None]
    key = torch.abs((r2 - r1) - med[:, None])
    prev = torch.zeros_like(inr)
    prev[:, 1:] = r1[:, 1:] == r1[:, :-1]
    new_run = inr & ~prev
    run = torch.where(inr, torch.cumsum(new_run.to(I64), 1) - 1, C)
    pack = key * C + col
    best = torch.full((T, C + 1), 1 << 62, dtype=I64, device=r1.device)
    best.scatter_reduce_(1, run, pack, reduce="amin")
    keep = inr & (pack == best.gather(1, run))
    return _compact(r1, r2, keep)


def _umvu(n, lo, hi):
    """Java Math.round((double)(int)(n*lo - hi) / (n-1)) as integers:
    floor quotient plus a half-up carry (den = max(n-1, 1))."""
    den = torch.clamp(n - 1, min=1)
    num = _w32(n * lo - hi)
    q = torch.div(num, den, rounding_mode="floor")
    rem = num - q * den
    return q + (2 * rem >= den).to(I64)


def _windowed_jaccard(a_h, a_p, m1, b_h, b_p, m2, a1, a2, b1, b2):
    """computeKBottomSketchJaccard in closed form: per hash value with
    in-window multiplicities c1, c2 the union merge spends max(c1, c2)
    steps, the first min(c1, c2) of them intersections; count those that
    fall within the first k = min(|f1|, |f2|) steps.  Returns (inter, k)."""
    T, S = a_h.shape
    slot = torch.arange(S, device=a_h.device)[None, :]
    in1 = (slot < m1[:, None]) & (a_p >= a1[:, None]) & (a_p <= a2[:, None])
    in2 = (slot < m2[:, None]) & (b_p >= b1[:, None]) & (b_p <= b2[:, None])
    k = torch.minimum(in1.sum(1), in2.sum(1))
    big = 1 << 40
    vals = torch.cat([torch.where(in1, a_h, big),
                      torch.where(in2, b_h, big)], 1)
    side = torch.cat([torch.zeros_like(a_h), torch.ones_like(b_h)], 1)
    sv, order = torch.sort(vals, 1)
    ss = side.gather(1, order)
    real = sv < big
    first = real.clone()
    first[:, 1:] &= sv[:, 1:] != sv[:, :-1]
    C = 2 * S
    run = torch.where(real, torch.cumsum(first.to(I64), 1) - 1, C)
    c1 = torch.zeros((T, C + 1), dtype=I64, device=a_h.device)
    c2 = torch.zeros_like(c1)
    c1.scatter_add_(1, run, (real & (ss == 0)).to(I64))
    c2.scatter_add_(1, run, (real & (ss == 1)).to(I64))
    c1, c2 = c1[:, :C], c2[:, :C]
    u = torch.maximum(c1, c2)
    cum_u = torch.cumsum(u, 1) - u
    contrib = torch.minimum(torch.clamp(k[:, None] - cum_u, min=0),
                            torch.minimum(c1, c2))
    return contrib.sum(1), k


def score_pairs_ref(a_h, a_p, a_m, a_nk, b_h, b_p, b_m, b_nk,
                    max_shift: float) -> torch.Tensor:
    """Plain version of the scorer kernel on gathered rows.

    a_h/a_p, b_h/b_p: [T, S] int32 sorted (hash, pos) sketches with PAD
    past a_m/b_m; a_nk/b_nk: [T] k-mer counts.  Returns int32 [T, 16]."""
    a_h, a_p, b_h, b_p = (x.to(I64) for x in (a_h, a_p, b_h, b_p))
    m1, nk1, m2, nk2 = (x.to(I64) for x in (a_m, a_nk, b_m, b_nk))
    T, S = a_h.shape
    slot = torch.arange(S, device=a_h.device)[None, :]

    def shared(h, m, oh, om):
        idx = torch.searchsorted(oh, h)
        found = oh.gather(1, torch.clamp(idx, max=S - 1)) == h
        return (slot < m[:, None]) & (idx < om[:, None]) & found

    fa = shared(a_h, m1, b_h, m2)
    fb = shared(b_h, m2, a_h, m1)
    ah, ap, n1 = _compact(a_h, a_p, fa)
    bh, bp, n2 = _compact(b_h, b_p, fb)

    zero = torch.zeros_like(nk1)
    am0 = _w32(torch.maximum(nk1, nk2) + 1)
    r1, r2, cnt1 = _merge_pass(ah, ap, n1, bh, bp, n2, zero, am0,
                               _windows(zero, am0, nk1, nk2))
    med1 = _median(r1, r2, cnt1)
    am1 = _abs_max(med1, nk1, nk2, max_shift)
    r1, r2, cnt2 = _merge_pass(ah, ap, n1, bh, bp, n2, med1, am1,
                               _windows(med1, am1, nk1, nk2))
    med2 = _median(r1, r2, cnt2)
    r1, r2, cnt3 = _optimize_shifts(r1, r2, cnt2, med2)
    med3 = _median(r1, r2, cnt3)
    am3 = _abs_max(med3, nk1, nk2, max_shift)

    col = torch.arange(r1.shape[1], device=a_h.device)[None, :]
    valid = (col < cnt3[:, None]) & (
        torch.abs((r2 - r1) - med3[:, None]) <= am3[:, None])
    nrec = valid.sum(1)
    l1 = torch.where(valid, r1, _IMAX).min(1).values
    l2 = torch.where(valid, r2, _IMAX).min(1).values
    u1 = torch.where(valid, r1, -_IMAX).max(1).values
    u2 = torch.where(valid, r2, -_IMAX).max(1).values
    a1 = torch.clamp(_umvu(nrec, l1, u1), min=0)
    a2 = torch.minimum(nk1, _umvu(nrec, u1, l1))
    b1 = torch.clamp(_umvu(nrec, l2, u2), min=0)
    b2 = torch.minimum(nk2, _umvu(nrec, u2, l2))
    inter, k = _windowed_jaccard(a_h, a_p, m1, b_h, b_p, m2, a1, a2, b1, b2)

    ok = (cnt1 > 0) & (cnt2 > 0) & (cnt3 > 0) & (nrec >= 3)
    out = torch.zeros((T, N_COLS), dtype=I64, device=a_h.device)
    cols = (ok.to(I64), inter, k, nrec, a1, a2, b1, b2, zero, cnt1, cnt2,
            cnt3, n1 + n2)
    for j, c in enumerate(cols):
        out[:, j] = c
    return out.to(torch.int32)
