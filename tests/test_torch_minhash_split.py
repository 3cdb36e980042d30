"""Kernel 2's three-pass design (csrc/minhash.cu) on the CPU.

The CUDA passes cannot run here, so a torch model of them stands in:
it takes the wrapper's own plan (``light_segments``, ``heavy_kmers``,
``heavy_unit_slots``) and the heavy pass's
jump arithmetic (``xorshift_jump`` over ``xorshift_jump_table``), with a
tiny tile and heavy threshold so that every path runs, and is held
bit-equal to the plain version, to ``weighted_min_reduce_pallas``
(interpret mode) and to the JAX scan formulation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhap_tpu.ops import minhash as jmh
from mhap_tpu.ops import u64
from mhap_tpu.ops.minhash_pallas import weighted_min_reduce_pallas
from mhap_tpu_torch.ops import minhash as tmh
from mhap_tpu_torch.ops.minhash_kernels import (heavy_kmers, heavy_unit_slots,
                                                light_segments,
                                                weighted_min_reduce)

torch.set_num_threads(1)
_I64_MAX = (1 << 63) - 1
_I32_MAX = (1 << 31) - 1
TABLE = tmh.xorshift_jump_table()


@jax.jit
def _plain_steps(hi, lo, j):
    """j steps of the JAX package's xorshift on (hi, lo) uint32 halves."""
    return jax.lax.fori_loop(0, j, lambda _, c: u64.xorshift(c), (hi, lo))


@pytest.mark.parametrize("j", [0, 1, 2, 63, 64, 1_000, 199 * 16 * 31,
                               30_000 * 16 * 31])
def test_xorshift_jump_equals_plain_steps(j):
    rng = np.random.default_rng(j % 1000)
    x = rng.integers(-2**63, 2**63 - 1, 6, dtype=np.int64)
    xu = x.view(np.uint64)
    hi, lo = _plain_steps(jnp.asarray((xu >> np.uint64(32)).astype(np.uint32)),
                          jnp.asarray((xu & np.uint64(0xFFFFFFFF))
                                      .astype(np.uint32)), j)
    want = ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64)).view(np.int64)
    got = tmh.xorshift_jump(torch.from_numpy(x), j, TABLE).numpy()
    np.testing.assert_array_equal(got, want)
    if j <= 64:  # and the port's own step
        t = torch.from_numpy(x)
        for _ in range(j):
            t = tmh.xorshift(t)
        np.testing.assert_array_equal(got, t.numpy())


def _heavy_values(h, weight, flat, H, jump_steps):
    """The heavy pass: thread q of heavy k-mer e takes the slots [q * r,
    min(H, (q + 1) * r)) (r from heavy_unit_slots), jumps the k-mer's
    stream by w * q * r steps, then steps w times for each slot."""
    hv = torch.full((len(flat), H), _I64_MAX, dtype=torch.int64)
    if not len(flat):
        return hv
    w_e = weight.reshape(-1)[flat].long()
    r_e = heavy_unit_slots(w_e, H, jump_steps)
    e, q = torch.meshgrid(torch.arange(len(flat)), torch.arange(H),
                          indexing="ij")
    e, q = e.reshape(-1), q.reshape(-1)
    keep = q * r_e[e] < H
    e, q = e[keep], q[keep]
    w, s0 = w_e[e], q * r_e[e]
    s1 = torch.clamp(s0 + r_e[e], max=H)
    x = tmh.xorshift_jump(h.reshape(-1)[flat][e], w * s0, TABLE)
    for d in range(int((s1 - s0).max())):
        on = s0 + d < s1
        wm = torch.full_like(x, _I64_MAX)
        for t in range(int(w.max())):
            adv = on & (t < w)
            nxt = tmh.xorshift(x)
            x = torch.where(adv, nxt, x)
            wm = torch.where(adv & (nxt < wm), nxt, wm)
        hv[e[on], (s0 + d)[on]] = wm[on]
    return hv


def three_pass_model(h, weight, active, tiebreak, H, jump_steps, heavy_min,
                     tile):
    """Light pass per segment, heavy pass per unit, fold per (row, slot);
    returns (sketch, winning index [B, H], segments, heavy k-mers)."""
    B, n = h.shape
    seg, nseg = light_segments(B, n, 2, tile)
    flat = heavy_kmers(weight, active, heavy_min)
    light = active & (weight < heavy_min)
    col = torch.arange(n)
    cands = []  # (value, tiebreak, index), each [B, H], in fold order
    for g in range(nseg):
        in_seg = (col >= g * seg) & (col < (g + 1) * seg)
        cands.append(tmh.weighted_argmin_ref(h, weight, light & in_seg[None],
                                             tiebreak, H))
    hv = _heavy_values(h, weight, flat, H, jump_steps)
    for e, f in enumerate(flat.tolist()):
        row = f // n
        v = torch.full((B, H), _I64_MAX, dtype=torch.int64)
        tb = torch.full_like(v, _I32_MAX)
        idx = torch.full_like(v, -1)
        v[row] = hv[e]
        tb[row] = int(tiebreak.reshape(-1)[f])
        idx[row] = f - row * n
        cands.append((v, tb, idx))
    best_v = torch.full((B, H), _I64_MAX, dtype=torch.int64)
    best_tb = torch.full_like(best_v, _I32_MAX)
    best_idx = torch.full_like(best_v, -1)
    for v, tb, idx in cands:
        less = (v < best_v) | ((v == best_v) & (tb < best_tb))
        best_v = torch.where(less, v, best_v)
        best_tb = torch.where(less, tb, best_tb)
        best_idx = torch.where(less, idx, best_idx)
    return tmh.winner_halves(h, best_idx), best_idx, nseg, flat


def _case(name):
    """(h, weight, active, tiebreak, H, heavy_min, tile) of a named case;
    tiebreaks are distinct first-occurrence-like positions, as the callers
    give them."""
    rng = np.random.default_rng(sum(map(ord, name)))
    B, n, H = 4, 24, 16
    h = rng.integers(-2**63, 2**63 - 1, (B, n), dtype=np.int64)
    w = rng.integers(1, 8, (B, n)).astype(np.int32)
    act = rng.random((B, n)) < 0.8
    tb = np.stack([rng.permutation(n) for _ in range(B)]).astype(np.int32)
    heavy_min, tile = 5, 16
    if name == "empty_row":
        act[1] = False
    elif name == "heavy_only":
        w[2] = rng.integers(5, 8, n)
    elif name == "no_heavy":
        w[:] = rng.integers(1, 5, (B, n))
    elif name == "h40":
        H = 40
        w[0, :6] = 7  # heavy units of r = 3 slots: the last takes 1
    elif name == "forced_ties":
        # one hash at equal weight in two segments (columns 1 and 17)
        # and among heavy entries (columns 4 and 20 at weight 6)
        # (rows 0 and 3 hold only the tied k-mers)
        h[0, 17], w[0, 17], w[0, 1] = h[0, 1], 3, 3
        h[0, 20], w[0, 20], w[0, 4] = h[0, 4], 6, 6
        h[3, 9], w[3, 9], w[3, 2] = h[3, 2], 7, 7
        act[[0, 3]] = False
        act[[0, 0, 0, 0, 3, 3], [1, 17, 4, 20, 2, 9]] = True
    return (torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(act),
            torch.from_numpy(tb), H, heavy_min, tile)


CASES = ["empty_row", "heavy_only", "no_heavy", "h40", "forced_ties"]


@pytest.mark.parametrize("name", CASES)
def test_plan_covers_every_active_kmer_once(name):
    h, w, act, tb, H, heavy_min, tile = _case(name)
    B, n = h.shape
    for n_sm in (1, 2, 64):
        seg, nseg = light_segments(B, n, n_sm, tile)
        assert 0 < seg <= tile and (seg % (tile // 16) == 0)
        assert (nseg - 1) * seg < n <= nseg * seg
    flat = heavy_kmers(w, act, heavy_min)
    heavy = torch.zeros(B * n, dtype=torch.bool)
    heavy[flat] = True
    assert len(flat) == int(heavy.sum())  # no entry twice
    assert (flat[1:] > flat[:-1]).all()  # ascending
    light = act & (w < heavy_min)
    assert torch.equal(heavy.reshape(B, n) | light, act)
    assert not (heavy.reshape(B, n) & light).any()
    # every heavy k-mer's units cut [0, H) into disjoint slot ranges
    r = heavy_unit_slots(w.reshape(-1)[flat], H, 20)
    for rk in r.tolist():
        cover = torch.zeros(H, dtype=torch.int64)
        for q in range(H):
            cover[q * rk:min(H, (q + 1) * rk)] += 1
        assert (cover == 1).all()
    assert (len(flat) == 0) == (name == "no_heavy")


@pytest.mark.parametrize("name", CASES)
def test_three_pass_model_matches_plain_and_pallas(name):
    h, w, act, tb, H, heavy_min, tile = _case(name)
    got, idx, nseg, _ = three_pass_model(h, w, act, tb, H, 20, heavy_min,
                                         tile)
    assert nseg > 1
    assert torch.equal(got, tmh.weighted_min_reduce_ref(h, w, act, tb, H))
    # the winners themselves, so that a tie goes to the smaller tiebreak
    assert torch.equal(idx, tmh.weighted_argmin_ref(h, w, act, tb, H)[2])
    hu = h.numpy().view(np.uint64)
    pallas = np.asarray(weighted_min_reduce_pallas(
        jnp.asarray((hu >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((hu & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray(w.numpy()), jnp.asarray(act.numpy()),
        jnp.asarray(tb.numpy()), num_hashes=H, w_max=8, interpret=True))
    # the Pallas kernel leaves rows without an active k-mer to its caller
    live = act.any(dim=1).numpy()
    np.testing.assert_array_equal(got.numpy()[live], pallas[live])
    if name == "forced_ties":
        # every slot of rows 0 and 3 is a tie, won by the smaller tiebreak
        for row, pairs in ((0, [(1, 17), (4, 20)]), (3, [(2, 9)])):
            keep = {min(pr, key=lambda c: int(tb[row, c])) for pr in pairs}
            assert set(idx[row].tolist()) <= keep


def test_three_pass_model_weight_100_matches_jax_scan():
    """One k-mer at weight 100 (heavy units of 1 slot past the first
    jump) against the JAX scan formulation, rows at weights 1..3."""
    rng = np.random.default_rng(5)
    B, n, H = 3, 40, 16
    h = rng.integers(-2**63, 2**63 - 1, (B, n), dtype=np.int64)
    w = rng.integers(1, 4, (B, n)).astype(np.int32)
    w[0, 7] = 100
    act = rng.random((B, n)) < 0.9
    act[0, 7] = True
    tb = np.tile(np.arange(n, dtype=np.int32), (B, 1))
    hu = h.view(np.uint64)
    want = np.asarray(jmh.weighted_min_reduce(
        jnp.asarray((hu >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((hu & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray(w), jnp.asarray(act), jnp.asarray(tb), num_hashes=H,
        w_max=128))
    got, _, _, flat = three_pass_model(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(act),
        torch.from_numpy(tb), H, 64, heavy_min=50, tile=16)
    assert len(flat) == 1
    np.testing.assert_array_equal(got.numpy(), want)


def test_argmin_split_gives_the_plain_version():
    """weighted_argmin_ref + winner_halves is the plain version; the
    arg-min's value is the winner's window minimum."""
    h, w, act, tb, H, _, _ = _case("empty_row")
    v, t, idx = tmh.weighted_argmin_ref(h, w, act, tb, H)
    assert (idx[1] == -1).all() and (v[1] == _I64_MAX).all()
    assert torch.equal(t[0], tb[0][idx[0]].long())
    x = h[0, idx[0, 3]]
    wk = int(w[0, idx[0, 3]])
    x = tmh.xorshift_jump(x, wk * 3, TABLE)
    vals = []
    for _ in range(wk):
        x = tmh.xorshift(x)
        vals.append(int(x))
    assert min(vals) == int(v[0, 3])
    assert torch.equal(weighted_min_reduce(h, w, act, tb, H, heavy_min=2),
                       tmh.winner_halves(h, idx))
