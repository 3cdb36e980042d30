"""Kernel 5's plain version (ops/swalign.sw_align_batch) against the JAX
``sw_align_batch`` (a lax.scan, no Pallas) on the same numpy pairs, bit
for bit on all eight outputs; against the native Smith-Waterman
(native/sw.cc) on score and ends exactly, on begins and identity within
tests/test_swalign.py's tolerances.  Then the CUDA kernel's decomposition
rehearsed on the CPU: a numpy model of its block (a team of WARPS warps
that take a pair's stripes in turn; in a warp, LANES lanes of ROWS query
rows each, an anti-diagonal inside a lane as across lanes, H and its stats
kept two steps by parity, row 0's up values shuffled from the lane before;
a stripe's top row read from the previous warp's border row once that warp
has published the columns, border rows that start as garbage, masked steps
at a stripe's ends, per-row bests folded in order of i, a (score, i, j)
shuffle reduction and then one across the team, in both stat layouts)
against the plain version at several warp, lane and row counts, the warps
run in a seeded random order.  All outputs are integers, so every
comparison is exact."""

import numpy as np
import pytest
import torch

from mhap_tpu.ops.swalign import sw_align_batch as sw_jax
from mhap_tpu_torch.ops.swalign import COLS, NEG, sw_align_batch
from mhap_tpu_torch.ops.swalign import pack_pairs as pack
from mhap_tpu_torch.ops.swalign_kernels import (LANES, PACKED_MAX, ROWS,
                                                STRIPE, WARPS, packed_stats)
from mhap_tpu_torch.ops.swalign_kernels import \
    sw_align_batch as sw_wrapper
from mhap_tpu_torch.utils import native
from torch_card_inputs import dna as random_dna
from torch_card_inputs import mutate_dna as mutate
from torch_card_inputs import sw_adversarial_pairs, sw_tie_pairs

torch.set_num_threads(1)


def swalign_pairs(seed):
    """tests/test_swalign.py's pairs at ``seed`` (31 there): 6 mutated
    genome windows, an identical and an unrelated pair."""
    rng = np.random.default_rng(seed)
    genome = random_dna(rng, 3000)
    pairs = []
    for _ in range(6):
        a = int(rng.integers(0, 2000))
        b = int(rng.integers(max(0, a - 300), a + 300))
        la = int(rng.integers(200, 500))
        lb = int(rng.integers(200, 500))
        pairs.append((mutate(rng, genome[a:a + la]),
                      mutate(rng, genome[b:b + lb])))
    pairs.append((genome[:300], genome[:300]))
    pairs.append((random_dna(rng, 300), random_dna(rng, 300)))
    return pairs


def run_jax(pairs, **kw):
    return {k: np.asarray(v) for k, v in
            sw_jax(*pack(pairs), **kw).items()}


def run_torch(pairs, fn=sw_align_batch, **kw):
    q, ql, r, rl = (torch.from_numpy(x) for x in pack(pairs))
    return {k: v.numpy() for k, v in fn(q, ql, r, rl, **kw).items()}


def assert_equal(got, want, label=""):
    for k in COLS:
        assert got[k].dtype == np.int32, (label, k, got[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"{label} {k}")


@pytest.mark.parametrize("seed", [31, 5, 2024])
def test_plain_vs_jax_swalign_pairs(seed):
    pairs = swalign_pairs(seed)
    assert_equal(run_torch(pairs), run_jax(pairs), f"seed {seed}")


def test_plain_vs_jax_adversarial():
    pairs = sw_adversarial_pairs(B=STRIPE)
    got = run_torch(pairs)
    assert_equal(got, run_jax(pairs), "adversarial")
    # the empty pairs and the unrelated single bases score 0 with no end
    for i in (10, 11, 12, 14):
        assert (got["score"][i], got["q_end"][i], got["r_end"][i],
                got["length"][i]) == (0, -1, -1, 0), i


def test_plain_vs_jax_ties():
    pairs = sw_tie_pairs()
    assert_equal(run_torch(pairs), run_jax(pairs), "ties")


@pytest.mark.parametrize("kind", ["one_pair", "lengths_0_1", "scoring"])
def test_plain_vs_jax_small(kind):
    rng = np.random.default_rng(3)
    g = random_dna(rng, 200)
    kw = {}
    if kind == "one_pair":
        pairs = [(b"ACGTACGTACGTACGTACGT", b"ACGTACGTACGTACGTACGT")]
    elif kind == "lengths_0_1":
        pairs = [(b"", b"A"), (b"A", b""), (b"A", b"A"), (b"C", b"AC")]
    else:  # other scores: ties fall elsewhere
        pairs = [(g[:80], mutate(rng, g[:80], 0.2)),
                 (b"ACGTTGCA" * 6, b"ACGTGCA" * 7)]
        kw = dict(match=1, mismatch=-1, gap_open=1, gap_extend=1)
    assert_equal(run_torch(pairs, **kw), run_jax(pairs, **kw), kind)


def test_identical_perfect():
    s = b"ACGTACGTACGTACGTACGT"
    out = {k: int(v[0]) for k, v in run_torch([(s, s)]).items()}
    assert out["score"] == 2 * len(s) and out["matches"] == len(s)
    assert out["errors"] == 0 and out["q_begin"] == out["r_begin"] == 0
    assert out["q_end"] == len(s) - 1 and out["r_end"] == len(s) - 1


@pytest.mark.parametrize("seed", [31, 8])
def test_plain_vs_native(seed):
    """Score and end coordinates exact; begins and identity within
    tests/test_swalign.py's slack (co-optimal paths)."""
    pairs = swalign_pairs(seed)
    out = run_torch(pairs)
    for i, (a, b) in enumerate(pairs):
        want = native.sw_align(a, b)
        assert out["score"][i] == want["score"], i
        assert out["q_end"][i] == want["q_end"], i
        assert out["r_end"][i] == want["r_end"], i
        assert abs(out["q_begin"][i] - want["q_begin"]) <= 2, i
        assert abs(out["r_begin"][i] - want["r_begin"]) <= 2, i
        got_id = 1 - out["errors"][i] / max(out["length"][i], 1)
        assert got_id == pytest.approx(want["identity"], abs=0.02), i


def test_wrapper_takes_plain_version_on_cpu():
    pairs = swalign_pairs(31)[:3]
    before = sw_wrapper.launches
    assert_equal(run_torch(pairs, sw_wrapper), run_torch(pairs), "wrapper")
    assert sw_wrapper.launches == before


# ---- a numpy model of csrc/swalign.cu: a team of warps a pair ----

M32 = 0xFFFFFFFF


class Warp:
    """One warp of the team, vectorised over its lanes x R rows: the values
    each lane holds, shuffles, loads and stores at each step, in the
    kernel's order, with the kernel's unmasked steps left unmasked.
    ``wide``: the 32-bit stats (M, L, Q, R, zeroed where H is 0); else the
    two words L << 16 | M and Q + 1 << 16 | R + 1 (the position of the
    path's first diagonal cell), not zeroed."""

    def __init__(self, team, w):
        self.team, self.w = team, w
        T = team
        self.lb = np.zeros(T.lanes, np.int64)  # the lane's best
        self.li = np.zeros(T.lanes, np.int64)
        self.lpos = np.zeros(T.lanes, np.int64)
        self.ls = np.zeros((T.W, T.lanes), np.int64)
        self.stripes = list(range(w * T.LR, T.ql, T.warps * T.LR))
        self.t = -1
        self.s = None  # the next step of the current stripe, None: between

    def start(self):
        """The next stripe's registers and prologue; False when done."""
        T, R, lanes = self.team, self.team.R, self.team.lanes
        self.t += 1
        if self.t >= len(self.stripes):
            return False
        i0 = self.stripes[self.t]
        self.g = i0 // T.LR  # the stripe's index in the pair
        self.rows = min(T.LR, T.ql - i0)
        self.total = T.rl + self.rows - 1
        self.i = i0 + T.x + 1
        self.row_on = self.i <= T.ql
        self.qc = np.where(self.row_on,
                           T.qa[np.minimum(self.i, max(T.ql, 1)) - 1], 0)
        W = T.W
        self.H = np.zeros((2, lanes, R), np.int64)  # by step parity
        self.HS = np.zeros((2, W, lanes, R), np.int64)
        self.E = np.full((lanes, R), NEG)
        self.F = np.full((lanes, R), NEG)
        self.ES = np.zeros((W, lanes, R), np.int64)
        self.FS = np.zeros((W, lanes, R), np.int64)
        self.U = np.zeros((2, lanes), np.int64)  # row 0's up H, by parity
        self.US = np.zeros((2, W, lanes), np.int64)
        self.rb = np.zeros((lanes, R), np.int64)
        self.rpos = np.zeros((lanes, R), np.int64)
        self.rs = np.zeros((W, lanes, R), np.int64)
        # the top row: the team's previous warp's border row, published
        # from column 0 at done[src] = wait_base
        self.src = (self.w - 1) % T.warps
        self.wait_base = -1 if i0 == 0 else \
            (self.t if self.w else self.t - 1) * T.rl
        self.pub_base = self.t * T.rl
        self.avail = 0
        self.s = 0
        self.B = None  # the prologue's loads, after its wait
        return True

    def ready(self, need):
        T = self.team
        if self.wait_base < 0 or need <= self.avail:
            return True
        d = T.done[self.src] - self.wait_base
        if d < need:
            return False
        self.avail = min(d, T.rl)
        return True

    def load(self, col):
        """Lane 0's load of a top-row column, with the stripe that wrote
        it (-1: the boundary)."""
        T = self.team
        return T.bord[self.src][col].copy(), T.ver[self.src][col]

    def publish(self, s):
        T = self.team
        cols = min(max(s - T.LR + 1, 0), T.rl)
        T.done[self.w] = self.pub_base + cols

    def advance(self):
        """Steps s and s + 1 of the current stripe, or the prologue; False
        while the top row's columns they read are unpublished."""
        T = self.team
        if self.B is None:
            if not self.ready(min(4, T.rl)):
                return False
            self.B = [self.load(1), self.load(2)]
            return True
        s = self.s
        lo = T.LR if self.rows == T.LR else self.total
        masked = not (s >= lo and s + 2 < T.rl)
        # masked steps wait for the columns of each two; steady ones for
        # those of 32 steps, at their start (32 steps on from the stripe's
        # first steady step, which the kernel's 32 x R is a multiple of)
        chunk = (s - T.LR) % 32 == 0
        need = min(s + 4, T.rl) if masked else \
            min(s + 34, T.rl) if chunk else 0
        if (s if masked else s - T.LR) % 32 == 0:
            self.publish(s)
        if not self.ready(need):
            return False
        self.step(s, 0, masked)
        self.step(s + 1, 1, masked)
        self.s = s + 2
        if self.s >= self.total:
            self.finish()
        return True

    def finish(self):
        T = self.team
        self.publish(T.rl + T.LR)
        for k in range(T.R):  # the rows' bests, in order of i
            upd = self.rb[:, k] > self.lb
            self.lb = np.where(upd, self.rb[:, k], self.lb)
            self.li = np.where(upd, self.i[:, k], self.li)
            self.lpos = np.where(upd, self.rpos[:, k], self.lpos)
            self.ls = np.where(upd, self.rs[:, :, k], self.ls)
        self.s = None

    def step(self, s, u, masked):
        T, R, x, W = self.team, self.team.R, self.team.x, self.team.W
        rl, m = T.rl, T.m
        H, HS, E, F, ES, FS = self.H, self.HS, self.E, self.F, self.ES, \
            self.FS
        jj = s - x + 1
        act = self.row_on & (jj >= 1) & (jj <= rl)
        pH, pHS = H[1 - u], HS[1 - u]
        # row 0's up: the lane before's last row at the last step (a
        # shuffle); lane 0 the top row's column loaded two steps ago
        (bv, bver) = self.B[u]
        if act[0, 0]:
            assert bver == self.g - 1, (bver, self.g, s)
        uh = np.concatenate([[bv[0]], pH[:-1, R - 1]])
        uf = np.concatenate([[bv[1]], F[:-1, R - 1]])
        uhs = np.concatenate([bv[2:2 + W, None], pHS[:, :-1, R - 1]], 1)
        ufs = np.concatenate([bv[2 + W:, None], FS[:, :-1, R - 1]], 1)
        col = min(s + 3, m + 1) if masked else s + 3
        assert col <= m + 1
        self.B[u] = self.load(col)
        if not masked:  # the next step's r stays inside rlen
            nxt = s + 1 - x
            assert nxt.min() >= 0 and nxt.max() <= rl - 1
        c = T.ra[np.clip(s - x, 0, m - 1)] if rl else np.zeros_like(x)
        hu = np.concatenate([uh[:, None], pH[:, :R - 1]], axis=1)
        fu = np.concatenate([uf[:, None], F[:, :R - 1]], axis=1)
        hsu = np.concatenate([uhs[:, :, None], pHS[:, :, :R - 1]], 2)
        fsu = np.concatenate([ufs[:, :, None], FS[:, :, :R - 1]], 2)
        hd = np.concatenate([self.U[1 - u][:, None], H[u][:, :R - 1]], 1)
        hsd = np.concatenate([self.US[1 - u][:, :, None],
                              HS[u][:, :, :R - 1]], 2)
        ev, eh = E - T.ge, pH - T.go
        e = np.maximum(ev, eh)
        es = (np.where(ev >= eh, ES, pHS) + T.L1) & M32
        fv, fh = fu - T.ge, hu - T.go
        f = np.maximum(fv, fh)
        fs = (np.where(fv >= fh, fsu, hsu) + T.L1) & M32
        mt = self.qc == c
        dg = hd + np.where(mt, T.match, T.mismatch)
        h = np.maximum(np.maximum(dg, 0), np.maximum(e, f))
        i = self.i
        if T.wide:
            pos = jj
            ds = np.stack([hsd[0] + mt, hsd[1] + 1,
                           np.where(hd == 0, i - 1, hsd[2]),
                           np.where(hd == 0, jj - 1, hsd[3])])
            hs = np.where(h == dg, ds, np.where(h == f, fs, es))
            hs = np.where(h > 0, hs, 0)
        else:
            pos = ((i << 16) + jj) & M32
            ds = np.stack([(np.where(hd == 0, 0, hsd[0])
                            + np.where(mt, 0x10001, 0x10000)) & M32,
                           np.where(hd == 0, pos, hsd[1])])
            hs = np.where(h == dg, ds, np.where(h == f, fs, es))
        keep = ~act if masked else np.zeros_like(act)
        H[u] = np.where(keep, pH, h)
        HS[u] = np.where(keep, pHS, hs)
        E[:] = np.where(keep, E, e)
        ES[:] = np.where(keep, ES, es)
        F[:] = np.where(keep, F, f)
        FS[:] = np.where(keep, FS, fs)
        upd = ~keep & (h > self.rb)
        self.rb[:] = np.where(upd, h, self.rb)
        self.rpos[:] = np.where(upd, pos, self.rpos)
        self.rs[:] = np.where(upd, hs, self.rs)
        self.U[u], self.US[u] = uh, uhs
        # the last lane's last row goes to the warp's border row
        if not keep[-1, -1]:
            j = jj[-1, -1]
            assert 1 <= j <= rl
            T.bord[self.w][j] = np.concatenate([[h[-1, -1], f[-1, -1]],
                                                hs[:, -1, -1], fs[:, -1, -1]])
            T.ver[self.w][j] = self.g


class Team:
    """Kernel 5's block on one pair: ``warps`` warps of ``lanes`` lanes of
    R query rows; warp w sweeps stripes w, w + warps, ...; each reads its
    top row from the previous warp's border row once that warp has
    published the columns (every 32 steps and at a stripe's end), and the
    warps run in an order drawn from ``seed``, so a warp that reads a
    column before it is written, or after it is overwritten, trips the
    model's checks of which stripe wrote it.  Border rows start as
    garbage; the last warp's is set to the top boundary, which warp 0
    reads above the first stripe."""

    def __init__(self, a, b, warps, lanes, R, wide, match=2, mismatch=-2,
                 go=2, ge=1, seed=0):
        rng = np.random.default_rng(seed)
        self.warps, self.lanes, self.R, self.wide = warps, lanes, R, wide
        self.match, self.mismatch, self.go, self.ge = match, mismatch, go, ge
        self.ql, self.rl = len(a), len(b)
        if self.rl == 0:
            self.ql = 0
        self.m = m = max(self.rl, 1)
        self.qa = np.frombuffer(a, np.uint8).astype(np.int64)
        self.ra = np.frombuffer(b, np.uint8).astype(np.int64)
        self.W = W = 4 if wide else 2
        self.L1 = np.array([0, 1, 0, 0] if wide else [1 << 16, 0])[:, None,
                                                                  None]
        self.LR = lanes * R
        self.x = np.arange(lanes)[:, None] * R + np.arange(R)[None, :]
        self.bord = [rng.integers(-99, 99, (m + 2, 2 + 2 * W))
                     for _ in range(warps)]
        self.ver = [np.full(m + 2, -99) for _ in range(warps)]
        self.bord[-1][:self.rl + 2] = [0, NEG] + [0] * (2 * W)
        self.ver[-1][:self.rl + 2] = -1
        self.done = [0] * warps
        self.order = rng

    def run(self):
        team = [Warp(self, w) for w in range(self.warps)]
        live = [wp for wp in team if wp.start()]
        while live:
            moved = False
            for wp in self.order.permutation(live):
                for _ in range(int(self.order.integers(1, 40))):
                    if not wp.advance():
                        break
                    moved = True
                    if wp.s is None:
                        if not wp.start():
                            live.remove(wp)
                        break
            assert moved, "every warp of the team waits: a deadlock"
        # each warp's best by a butterfly of shuffles, then the team's in
        # order of warps: the largest score, then the smallest (i, j)
        best = None
        for wp in team:
            lb, li, lpos, ls = wp.lb, wp.li, wp.lpos, wp.ls
            t = np.arange(self.lanes)
            off = self.lanes // 2
            while off:
                o = t ^ off
                take = (lb[o] > lb) | ((lb[o] == lb)
                                       & self.earlier(li[o], lpos[o], li,
                                                      lpos))
                lb, li, lpos = (np.where(take, v[o], v)
                                for v in (lb, li, lpos))
                ls = np.where(take, ls[:, o], ls)
                off //= 2
            cand = (int(lb[0]), int(li[0]), int(lpos[0]), ls[:, 0])
            if best is None or cand[0] > best[0] or (
                    cand[0] == best[0]
                    and self.earlier(cand[1], cand[2], best[1], best[2])):
                best = cand
        score, bi, bpos, bs = best
        if score == 0:
            return dict(zip(COLS, (0, -1, -1, 0, 0, 0, 0, 0)))
        if self.wide:
            Mm, Ll, Q, Rr = bs
            bj = bpos
        else:  # positions of the path's first diagonal cell: begin + 1
            bi, bj = bpos >> 16, bpos & 0xFFFF
            Ll, Mm = bs[0] >> 16, bs[0] & 0xFFFF
            Q, Rr = (bs[1] >> 16) - 1, (bs[1] & 0xFFFF) - 1
        return dict(zip(COLS, (score, int(bi) - 1, int(bj) - 1, int(Q),
                               int(Rr), int(Mm), int(Ll - Mm), int(Ll))))

    def earlier(self, ai, apos, bi, bpos):
        if self.wide:
            return (ai < bi) | ((ai == bi) & (apos < bpos))
        return apos < bpos


def model_batch(pairs, warps, lanes, R, wide, **kw):
    outs = [Team(a, b, warps, lanes, R, wide, seed=n, **kw).run()
            for n, (a, b) in enumerate(pairs)]
    return {k: np.array([o[k] for o in outs], np.int32) for k in COLS}


@pytest.mark.parametrize("warps,lanes,R,wide", [
    (WARPS, LANES, ROWS, False), (WARPS, LANES, ROWS, True),
    (3, 4, 2, False)])
def test_team_model_vs_plain_adversarial(warps, lanes, R, wide):
    """The kernel's team in both stat layouts over the adversarial batch,
    whose lengths straddle its stripe; 3 warps of 4 lanes of 2 rows cut
    each pair into up to 25 stripes, so every border row is written,
    waited for and overwritten again and again."""
    pairs = sw_adversarial_pairs(B=STRIPE)
    assert_equal(model_batch(pairs, warps, lanes, R, wide),
                 run_torch(pairs), f"{warps}x{lanes}x{R} wide={wide}")


@pytest.mark.parametrize("warps,lanes,R,wide", [
    (WARPS, LANES, ROWS, False), (2, 2, 3, True)])
def test_team_model_vs_plain_ties(warps, lanes, R, wide):
    pairs = sw_tie_pairs()
    assert_equal(model_batch(pairs, warps, lanes, R, wide),
                 run_torch(pairs), f"{warps}x{lanes}x{R} wide={wide}")


@pytest.mark.parametrize("warps,lanes,R,wide", [
    (WARPS, LANES, ROWS, False), (2, 16, 2, True)])
def test_team_model_vs_plain_mutated(warps, lanes, R, wide):
    pairs = swalign_pairs(31)[:3] + [swalign_pairs(31)[7]]
    assert_equal(model_batch(pairs, warps, lanes, R, wide),
                 run_torch(pairs), f"{warps}x{lanes}x{R} wide={wide}")


@pytest.mark.parametrize("wide", [False, True])
def test_team_model_one_warp_one_lane_one_row(wide):
    """One warp of one lane of one row: lane 0 is lane 31 too, the reader
    and the writer of one border row, in place, and each stripe is one
    row."""
    pairs = [p for p in sw_adversarial_pairs(B=STRIPE) if len(p[0]) <= 40
             and len(p[1]) <= 45]
    assert len(pairs) == 7
    assert_equal(model_batch(pairs, 1, 1, 1, wide), run_torch(pairs),
                 f"1x1x1 wide={wide}")


@pytest.mark.parametrize("scores", [(1, -1, 1, 1), (3, -1, 0, 0),
                                    (2, -2, -1, 1)])
def test_team_model_other_scores(scores):
    """Other scores move the ties; gap penalties of 0 are the edge of the
    packed layout's unzeroed stats, and a negative one takes the 32-bit
    layout, as the wrapper chooses."""
    match, mismatch, go, ge = scores
    kw = dict(match=match, mismatch=mismatch, gap_open=go, gap_extend=ge)
    pairs = sw_tie_pairs()[:12] + [sw_adversarial_pairs(B=STRIPE)[k]
                                   for k in (2, 4, 6, 8)]
    wide = not packed_stats(200, 200, go, ge)
    assert wide == (go < 0)
    got = model_batch(pairs, WARPS, LANES, ROWS, wide, match=match,
                      mismatch=mismatch, go=go, ge=ge)
    assert_equal(got, run_torch(pairs, **kw), f"{scores}")


def test_packed_stats_choice():
    """Two-word stats while every field fits 16 bits and no gap penalty is
    negative; 32-bit ones past that, with no size refused."""
    assert PACKED_MAX == 65535 and STRIPE == LANES * ROWS
    assert packed_stats(33_000, 32_535, 2, 1)
    assert not packed_stats(33_000, 32_536, 2, 1)
    assert packed_stats(1, 1, 0, 0)
    assert not packed_stats(1, 1, -1, 1) and not packed_stats(1, 1, 2, -1)
