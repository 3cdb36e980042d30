"""Kernel 3's block decomposition (csrc/scorer.cu) on the CPU.

The CUDA kernel cannot run here, so a model of its stages stands in, in
the kernel's order and with its arithmetic, over a block of ``B`` threads
that each own a contiguous chunk (``_chunks``, the kernel's chunk_of):

  1. each run of equal hashes in A finds the run of the same hash in B
     (its partner: the kernel's merge path over A and B stands at the
     lower bound that ``bisect`` gives);
  2. recordMatchingKmers as one automaton per run pair, run r of A
     against run r of B (records as index pairs), each run pair writing
     the slots from floor(2 (s1 + s2) / 3) on, which never overlap; the
     slots are then compacted (chunks of ``K_PER`` per thread, placed by
     an exclusive prefix sum over the threads), which leaves the records
     in hash order;
  3. medians by an 8-bit radix select of shift - (least shift), from the
     digit of the highest bit of the shifts' range;
  4. optimizeShifts as a segmented arg-min over adjacent equal pos1,
     segmented over the whole record list (a scan of thread aggregates),
     then a stable compaction;
  5. UMVU edges from min/max/count reductions;
  6. the windowed Jaccard from ranks (searches into the compacted
     in-window lists) and a prefix sum of min(c1, c2) over run starts.

The model is held to ``score_pairs_ref`` on all 16 columns and to the
oracle automaton (``get_overlap_info``) on every lane, on
test_torch_scorer.py's generators and on forced cases.
"""

import bisect

import numpy as np
import pytest
import torch
from test_torch_scorer import CASES, _gen

from mhap_tpu.oracle import scorer as osc
from mhap_tpu_torch.ops.scorer import N_COLS, score_pairs_ref

torch.set_num_threads(1)
IMAX = 0x7FFFFFFF
K_PER = 9


def _w32(x: int) -> int:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _chunks(n: int, B: int):
    """chunk_of: thread t's [lo, hi), odd chunk length."""
    c = (-(-n // B)) | 1
    return [(min(n, t * c), min(n, t * c + c)) for t in range(B)]


def _excl(vals):
    out, acc = [], 0
    for v in vals:
        out.append(acc)
        acc += v
    return out, acc


def _abs_max(med, nk1, nk2, max_shift):
    left = max(0, _w32(-med))
    right = min(nk1, _w32(nk2 - med))
    overlap = max(10, _w32(right - left))
    return min(max(nk1, nk2), int(overlap * max_shift))


def _pass(med, am, nk1, nk2):
    return (med, am, max(0, _w32(-med - am)), min(nk1, _w32(nk2 - med + am)),
            max(0, _w32(med - am)), min(nk2, _w32(nk1 + med + am)))


def _run_pair(ah, ap, m1, bh, bp, m2, s1, s2, q):
    """run_pair: the automaton with both cursors inside one hash's runs."""
    med, am, v1l, v1u, v2l, v2u = q
    v = ah[s1]
    i1, i2, out = s1, s2, []
    while i1 < m1 and i2 < m2 and ah[i1] == v and bh[i2] == v:
        p1, p2 = ap[i1], bp[i2]
        if p1 < v1l or p1 >= v1u:
            i1 += 1
        elif p2 < v2l or p2 >= v2u:
            i2 += 1
        else:
            diff = (p2 - p1) - med
            if diff > am:
                i1 += 1
            elif diff < -am:
                i2 += 1
            else:
                out.append((i1, i2))
                e1 = i1
                while (e1 + 1 < m1 and ah[e1 + 1] == v
                       and v1l <= ap[e1 + 1] < v1u):
                    e1 += 1
                e2 = i2
                while (e2 + 1 < m2 and bh[e2 + 1] == v
                       and v2l <= bp[e2 + 1] < v2u):
                    e2 += 1
                if e1 != i1 or e2 != i2:
                    out.append((e1, e2))
                i1, i2 = e1 + 1, e2 + 1
    return out


def _median(shifts):
    """Radix select of rank len // 2 on shift - min(shifts) as unsigned,
    8 bits a pass, from the digit of the highest bit of the range."""
    if not shifts:
        return IMAX
    lo = min(shifts)
    keys = [(x - lo) & 0xFFFFFFFF for x in shifts]
    rng = (max(shifts) - lo) & 0xFFFFFFFF
    if rng == 0:
        return lo
    prefix, k = 0, len(keys) // 2
    for d in range((rng.bit_length() - 1) // 8 * 8, -1, -8):
        high = 0 if d == 24 else (0xFFFFFFFF << (d + 8)) & 0xFFFFFFFF
        hist = [0] * 256
        for key in keys:
            if key & high == prefix:
                hist[(key >> d) & 255] += 1
        acc = 0
        for b in range(256):
            if acc + hist[b] > k:
                break
            acc += hist[b]
        prefix |= b << d
        k -= acc
    return _w32(lo + prefix)


def _compact(slots, B):
    """compact_slots: threads hold K_PER slots each, in rounds of B * K_PER
    slots, and write their filled ones from an exclusive prefix sum."""
    out = []
    for base in range(0, len(slots), B * K_PER):
        chunks = [[x for x in slots[base + t * K_PER:base + (t + 1) * K_PER]
                   if x is not None] for t in range(B)]
        offs, total = _excl([len(c) for c in chunks])
        dst = [None] * total
        for off, c in zip(offs, chunks):
            dst[off:off + len(c)] = c
        out += dst
    return out


def _seg_op(a, b):
    return (a[0] | b[0], b[1] if b[0] else min(a[1], b[1]))


def kernel_model(ah, ap, m1, nk1, bh, bp, m2, nk2, max_shift, B):
    """One block's stages on one pair; returns the 16 output columns."""
    ah, ap, bh, bp = (list(map(int, x)) for x in (ah, ap, bh, bp))
    S = len(ah)
    r_cap = max(4 * S // 3, 4 * (-(-S // 32)))
    a_chunks = _chunks(m1, B)
    # 1. run pairs
    partner, n_shared = {}, 0
    for lo, hi in a_chunks:
        for i in range(lo, hi):
            v = ah[i]
            if i == 0 or ah[i - 1] != v:
                lb = bisect.bisect_left(bh, v, 0, m2)
                if lb < m2 and bh[lb] == v:
                    partner[i] = lb
                    n_shared += (bisect.bisect_right(ah, v, i, m1) - i
                                 + bisect.bisect_right(bh, v, lb, m2) - lb)

    # 2. merge passes: each run pair writes its own slots, then the
    # slots are compacted chunk by chunk
    def merge_pass(q):
        span = 2 * (m1 + m2) // 3
        assert span <= r_cap
        slots = [None] * span
        for lo, hi in a_chunks:
            for i in range(lo, hi):
                if i in partner:
                    off = 2 * (i + partner[i]) // 3
                    for r in _run_pair(ah, ap, m1, bh, bp, m2, i, partner[i],
                                       q):
                        assert slots[off] is None
                        slots[off] = r
                        off += 1
        return _compact(slots, B)

    def shifts(rec):
        return [bp[b] - ap[a] for a, b in rec]

    am0 = _w32(max(nk1, nk2) + 1)
    rec1 = merge_pass(_pass(0, am0, nk1, nk2))
    med1 = _median(shifts(rec1))
    am1 = _abs_max(med1, nk1, nk2, max_shift)
    rec2 = merge_pass(_pass(med1, am1, nk1, nk2))
    med2 = _median(shifts(rec2))

    # 4. optimizeShifts: thread aggregates, exclusive segmented scan, marks
    n = len(rec2)

    def start(i):
        return i == 0 or ap[rec2[i][0]] != ap[rec2[i - 1][0]]

    def key(i):
        return abs(shifts([rec2[i]])[0] - med2) << 24 | i

    chunks = _chunks(n, B)
    aggs = []
    for lo, hi in chunks:
        agg = (0, 1 << 64)
        for i in range(lo, hi):
            agg = _seg_op(agg, (start(i), key(i)))
        aggs.append(agg)
    keep = [False] * n
    carry = (0, 1 << 64)
    for (lo, hi), agg in zip(chunks, aggs):
        run = carry
        for i in range(lo, hi):
            run = _seg_op(run, (start(i), key(i)))
            if i == n - 1 or start(i + 1):
                keep[run[1] & 0xFFFFFF] = True
        carry = _seg_op(carry, agg)
    rec3 = _compact([r if k else None for r, k in zip(rec2, keep)], B)
    med3 = _median(shifts(rec3))
    am3 = _abs_max(med3, nk1, nk2, max_shift)

    # 5. UMVU edges
    valid = [(ap[a], bp[b]) for a, b in rec3
             if abs((bp[b] - ap[a]) - med3) <= am3]
    nrec = len(valid)
    l1 = min([r1 for r1, _ in valid], default=IMAX)
    l2 = min([r2 for _, r2 in valid], default=IMAX)
    u1 = max([r1 for r1, _ in valid], default=-IMAX)
    u2 = max([r2 for _, r2 in valid], default=-IMAX)
    den = max(nrec - 1, 1)

    def umvu(lo, hi):
        num = _w32(nrec * lo - hi)
        q = num // den
        return q + (2 * (num - q * den) >= den)

    a1, a2 = max(0, umvu(l1, u1)), min(nk1, umvu(u1, l1))
    b1, b2 = max(0, umvu(l2, u2)), min(nk2, umvu(u2, l2))

    # 6. windowed Jaccard from ranks
    f1 = [ah[i] for i in range(m1) if a1 <= ap[i] <= a2]
    f2 = [bh[i] for i in range(m2) if b1 <= bp[i] <= b2]
    F1, F2 = len(f1), len(f2)
    k = min(F1, F2)
    chunks = _chunks(F1, B)
    mn_of, lb_of = [0] * F1, [0] * F1
    for lo, hi in chunks:
        for j in range(lo, hi):
            v = f1[j]
            if j == 0 or f1[j - 1] != v:
                lb2 = bisect.bisect_left(f2, v)
                lb_of[j] = lb2
                if lb2 < F2 and f2[lb2] == v:
                    mn_of[j] = min(bisect.bisect_right(f1, v, j) - j,
                                   bisect.bisect_right(f2, v, lb2) - lb2)
    offs, _ = _excl([sum(mn_of[lo:hi]) for lo, hi in chunks])
    inter = 0
    for (lo, hi), M in zip(chunks, offs):
        for j in range(lo, hi):
            if mn_of[j]:
                inter += min(max(k - (j + lb_of[j] - M), 0), mn_of[j])
                M += mn_of[j]

    cnt1, cnt2, cnt3 = len(rec1), len(rec2), len(rec3)
    ok = int(cnt1 > 0 and cnt2 > 0 and cnt3 > 0 and nrec >= 3)
    return [ok, inter, k, nrec, a1, a2, b1, b2, 0, cnt1, cnt2, cnt3,
            n_shared] + [0] * (N_COLS - 13)


def _side(S, h, p, nk):
    """One padded sketch row from (hash, pos) in the given order."""
    oh = np.full(S, IMAX, np.int32)
    op = np.full(S, IMAX, np.int32)
    oh[:len(h)], op[:len(p)] = h, p
    return oh, op, len(h), nk


def _sorted_side(S, h, p, nk):
    o = np.lexsort((p, h))
    return _side(S, np.asarray(h)[o], np.asarray(p)[o], nk)


def _stack(pairs):
    cols = []
    for side in range(2):
        rows = [pr[side] for pr in pairs]
        cols.append([np.stack([r[0] for r in rows]),
                     np.stack([r[1] for r in rows]),
                     np.array([r[2] for r in rows], np.int32),
                     np.array([r[3] for r in rows], np.int32)])
    return cols


def forced_pairs(S: int = 64):
    """Pairs aimed at the decomposition's seams."""
    rng = np.random.default_rng(5)
    base = np.arange(100, 100 + 40, dtype=np.int32) * 7
    pos = np.arange(40, dtype=np.int32) * 3
    pairs = []
    # a run whose middle entries fall outside the pass-2 window of A
    # (nk2 small: v1u = nk2 - med + am), positions left unsorted in it
    h = np.concatenate([base[:30], [5] * 6])
    pa = np.concatenate([pos[:30], [10, 900, 950, 12, 14, 980]])
    pb = np.concatenate([pos[:30], [10, 11, 12, 13, 14, 15]])
    pairs.append((_side(S, *zip(*sorted(zip(h.tolist(), pa.tolist()),
                                        key=lambda x: x[0])), 1000),
                  _side(S, *zip(*sorted(zip(h.tolist(), pb.tolist()),
                                        key=lambda x: x[0])), 100)))
    # positions repeated across hashes: pos1 runs span hash runs
    for seed in range(3):
        r = np.random.default_rng(seed)
        ha = r.integers(0, 20, S)
        hb = r.integers(0, 20, S)
        pairs.append((_sorted_side(S, ha, r.integers(0, 4, S), 200),
                      _sorted_side(S, hb, r.integers(0, 30, S), 200)))
    # one run of S equal hashes each side
    pairs.append((_sorted_side(S, [3] * S, rng.integers(0, 150, S), 160),
                  _sorted_side(S, [3] * S, rng.integers(0, 150, S), 150)))
    # all hashes shared, distinct, with shifts around 4
    hs = rng.choice(10**6, S, replace=False)
    ps = rng.integers(0, 200, S)
    pairs.append((_sorted_side(S, hs, ps, 210),
                  _sorted_side(S, hs, ps + rng.integers(2, 7, S), 220)))
    # none shared
    pairs.append((_sorted_side(S, np.arange(S) * 2, np.arange(S), 80),
                  _sorted_side(S, np.arange(S) * 2 + 1, np.arange(S), 80)))
    # shared hashes whose positions lie past num_kmers: no record at all
    pairs.append((_sorted_side(S, np.arange(10), np.arange(50, 60), 20),
                  _sorted_side(S, np.arange(10), np.arange(10), 20)))
    # exactly 3 and 4 matching k-mers: odd and even record counts
    for n in (3, 4):
        pairs.append((_sorted_side(S, base[:n], pos[:n], 150),
                      _sorted_side(S, base[:n], pos[:n] + 1, 150)))
    # duplicate hashes inside the Jaccard windows, unequal multiplicities
    h1 = np.concatenate([base[:20], [9] * 3, [11] * 2, [13]])
    h2 = np.concatenate([base[:20], [9], [11] * 4, [13] * 2])
    p1 = np.concatenate([pos[:20], [20, 22, 24, 30, 31, 40]])
    p2 = np.concatenate([pos[:20], [21, 29, 30, 31, 32, 41, 42]])
    pairs.append((_sorted_side(S, h1, p1, 120),
                  _sorted_side(S, h2, p2, 120)))
    # empty rows
    pairs.append((_side(S, [], [], 30), _sorted_side(S, [1], [1], 30)))
    return _stack(pairs)


def _check(a, b, B):
    T = len(a[2])
    want = score_pairs_ref(*[torch.from_numpy(x) for x in a + b],
                           0.2).numpy()
    for t in range(T):
        got = kernel_model(a[0][t], a[1][t], int(a[2][t]), int(a[3][t]),
                           b[0][t], b[1][t], int(b[2][t]), int(b[3][t]), 0.2,
                           B)
        assert got == want[t].tolist(), (t, got, want[t].tolist())
        s1 = np.stack([a[0][t, :a[2][t]], a[1][t, :a[2][t]]], 1)
        s2 = np.stack([b[0][t, :b[2][t]], b[1][t, :b[2][t]]], 1)
        oracle = osc.get_overlap_info(s1, int(a[3][t]), s2, int(b[3][t]), 12,
                                      0.2)
        if not got[0]:
            assert oracle == osc.EMPTY, t
            continue
        ident = osc.jaccard_to_identity(got[1] / max(got[2], 1), 12)
        assert (ident, float(got[3]), *got[4:8]) == oracle, t
    return want


@pytest.mark.parametrize("B", [5, 128])
@pytest.mark.parametrize("case", sorted(CASES))
def test_model_matches_plain_and_oracle(case, B):
    seed, S, T, lo, hi, frac = CASES[case]
    a, b = _gen(np.random.default_rng(seed), S, T, lo, hi, frac)
    _check(a, b, B)


@pytest.mark.parametrize("B", [1, 5, 128])
def test_model_on_forced_pairs(B):
    a, b = forced_pairs()
    want = _check(a, b, B)
    # the cases reach what they aim at
    assert want[0, 0] and want[:, 0].sum() >= 6
    assert not want[6, 0] and want[6, 12] == 0          # none shared
    assert want[7, 12] == 20 and want[7, 9] == 0        # shared, no record
    assert {want[8, 9] % 2, want[9, 9] % 2} == {0, 1}   # odd and even
    assert want[4, 12] == 128 and want[4, 9] > 0        # one run of S
