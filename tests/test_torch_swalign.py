"""Kernel 5's plain version (ops/swalign.sw_align_batch) against the JAX
``sw_align_batch`` (a lax.scan, no Pallas) on the same numpy pairs, bit
for bit on all eight outputs; against the native Smith-Waterman
(native/sw.cc) on score and ends exactly, on begins and identity within
tests/test_swalign.py's tolerances.  Then the CUDA kernel's decomposition
rehearsed on the CPU: a numpy model of its blocks (query rows in stripes
of B threads, an anti-diagonal skew, a shared-memory ping-pong between
neighbouring threads, a stripe's top row through a border buffer written
in place, per-thread bests on strict > and a (score, i) block reduction)
against the plain version.  All outputs are integers, so every comparison
is exact."""

import numpy as np
import pytest
import torch

from chip_smoke import dna as random_dna
from chip_smoke import mutate_dna as mutate
from chip_smoke import sw_adversarial_pairs
from mhap_tpu.ops.swalign import sw_align_batch as sw_jax
from mhap_tpu_torch.ops.swalign import COLS, NEG, sw_align_batch
from mhap_tpu_torch.ops.swalign import pack_pairs as pack
from mhap_tpu_torch.ops.swalign_kernels import THREADS
from mhap_tpu_torch.ops.swalign_kernels import \
    sw_align_batch as sw_wrapper
from mhap_tpu_torch.utils import native

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
    pairs = sw_adversarial_pairs(B=THREADS)
    got = run_torch(pairs)
    assert_equal(got, run_jax(pairs), "adversarial")
    # the empty pairs and the unrelated single bases score 0 with no end
    for i in (10, 11, 12, 14):
        assert (got["score"][i], got["q_end"][i], got["r_end"][i],
                got["length"][i]) == (0, -1, -1, 0), i


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


# ---- a numpy model of csrc/swalign.cu, one block a pair ----

FIELDS = 10  # H, F, then M, L, Q, R of H and of F


def kernel_model(a: bytes, b: bytes, B: int, match=2, mismatch=-2, go=2,
                 ge=1, seed=0):
    """Kernel 5's block on one pair, vectorised over its B threads: the
    values each thread holds, reads and writes at each step, in the
    kernel's order.  Shared and border memory start as garbage, which only
    an out-of-order read would see."""
    rng = np.random.default_rng(seed)
    ql, rl = len(a), len(b)
    qa = np.frombuffer(a, np.uint8).astype(np.int64)
    ra = np.frombuffer(b, np.uint8).astype(np.int64)
    buf = rng.integers(-99, 99, (2, FIELDS, B))
    border = rng.integers(-99, 99, (rl + 1, FIELDS))
    t = np.arange(B)
    best = np.zeros(B, np.int64)
    bi = np.full(B, np.iinfo(np.int32).max)
    bj = np.zeros(B, np.int64)
    bs = np.zeros((4, B), np.int64)
    for base in range(0, ql, B):
        i = base + t + 1
        row_on = i <= ql
        qc = np.where(row_on, qa[np.minimum(i, max(ql, 1)) - 1]
                      if ql else 0, 0)
        first = base == 0
        hand_down = base + B < ql
        rows = min(B, ql - base)
        hl = np.zeros(B, np.int64)
        el = np.full(B, NEG)
        hd = np.zeros(B, np.int64)
        hsl = np.zeros((4, B), np.int64)
        esl = np.zeros((4, B), np.int64)
        hsd = np.zeros((4, B), np.int64)
        for s in range(rl + rows - 1):
            j = s - t + 1
            act = row_on & (j >= 1) & (j <= rl)
            if not act.any():
                continue
            up = np.empty((FIELDS, B), np.int64)
            up[:, 1:] = buf[(s + 1) & 1][:, :-1]  # thread t-1, last step
            if first:
                up[:, 0] = [0, NEG] + [0] * 8
            elif act[0]:
                up[:, 0] = border[j[0]]
            hu, fu, hsu, fsu = up[0], up[1], up[2:6], up[6:10]
            eext = el - ge >= hl - go
            e = np.where(eext, el - ge, hl - go)
            es = np.where(eext, esl, hsl) + [[0], [1], [0], [0]]
            fext = fu - ge >= hu - go
            f = np.where(fext, fu - ge, hu - go)
            fs = np.where(fext, fsu, hsu) + [[0], [1], [0], [0]]
            mt = (qc == ra[np.clip(j - 1, 0, max(rl - 1, 0))]).astype(
                np.int64)
            dg = hd + np.where(mt == 1, match, mismatch)
            ds = np.stack([hsd[0] + mt, hsd[1] + 1,
                           np.where(hd == 0, i - 1, hsd[2]),
                           np.where(hd == 0, j - 1, hsd[3])])
            h = np.maximum(np.maximum(dg, 0), np.maximum(e, f))
            hs = np.where(h == dg, ds, np.where(h == f, fs, np.where(
                h == e, es, 0)))
            hs = np.where(h > 0, hs, 0)
            new = np.concatenate([h[None], f[None], hs, fs])
            wr = buf[s & 1]
            wr[:, act] = new[:, act]
            if hand_down and act[B - 1]:
                border[j[B - 1]] = new[:, B - 1]
            upd = act & (h > best)
            best = np.where(upd, h, best)
            bi = np.where(upd, i, bi)
            bj = np.where(upd, j, bj)
            bs = np.where(upd, hs, bs)
            hd = np.where(act, hu, hd)
            hsd = np.where(act, hsu, hsd)
            hl = np.where(act, h, hl)
            el = np.where(act, e, el)
            hsl = np.where(act, hs, hsl)
            esl = np.where(act, es, esl)
    w = 0
    for k in range(1, B):
        if best[k] > best[w] or (best[k] == best[w] and bi[k] < bi[w]):
            w = k
    if best[w] == 0:
        return dict(zip(COLS, (0, -1, -1, 0, 0, 0, 0, 0)))
    M, L, Q, R = (int(x) for x in bs[:, w])
    return dict(zip(COLS, (int(best[w]), int(bi[w]) - 1, int(bj[w]) - 1, Q,
                           R, M, L - M, L)))


def model_batch(pairs, B, **kw):
    outs = [kernel_model(a, b, B, seed=n, **kw)
            for n, (a, b) in enumerate(pairs)]
    return {k: np.array([o[k] for o in outs], np.int32) for k in COLS}


@pytest.mark.parametrize("B", [4, 32, THREADS])
def test_kernel_model_vs_plain_adversarial(B):
    """Stripes of B rows (a few, a warp, the kernel's block) over the
    adversarial batch, whose lengths straddle 128; B = 4 cuts every pair
    into many stripes, so each crosses the border buffer."""
    pairs = sw_adversarial_pairs(B=THREADS)
    assert_equal(model_batch(pairs, B), run_torch(pairs), f"B={B}")


@pytest.mark.parametrize("B", [16, THREADS])
def test_kernel_model_vs_plain_mutated(B):
    pairs = swalign_pairs(31)[:3] + [swalign_pairs(31)[7]]
    assert_equal(model_batch(pairs, B), run_torch(pairs), f"B={B}")


def test_kernel_model_one_thread():
    """B = 1: one thread is both the reader and the writer of the border
    buffer, a stripe a row."""
    pairs = [p for p in sw_adversarial_pairs(B=THREADS) if len(p[0]) <= 40
             and len(p[1]) <= 45]
    assert len(pairs) == 7
    assert_equal(model_batch(pairs, 1), run_torch(pairs), "B=1")
