"""Kernel 4's plain version (ops/merge.merge2_ref) against the Pallas
``merge2_pallas`` in interpret mode, on the same numpy rows: sorted 2-limb
uint32 keys with pads (0xFFFFFFFF, 0xFFFFFFFF) in the suffix.  Then the
CUDA kernel's partition rehearsed on the CPU: a row cut into tiles at
``merge_path_split`` points and each tile into threads' diagonals, merged
piece by piece, against both.  All outputs are integers, so every
comparison is exact."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhap_tpu.ops.merge_pallas import merge2_pallas
from mhap_tpu_torch.ops.merge import (merge2_ref, merge_path_split,
                                      pack_keys, unpack_keys)
from mhap_tpu_torch.ops.merge_kernels import merge2

UMAX = np.uint32(0xFFFFFFFF)
# high limbs around the sign bit and the top, so that signed and
# unsigned orders differ
HI_VALUES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                      0xFFFFFFFF], np.uint32)


def sorted_rows(rng, T, S, m):
    """[T, S] limb pairs, row t sorted with its first m[t] entries real
    (values from small spaces: duplicate keys) and pads after."""
    hi = rng.choice(HI_VALUES, (T, S))
    lo = rng.choice(np.array([0, 3, 0x80000000, 0xFFFFFFFF], np.uint32),
                    (T, S))
    for t in range(T):
        o = np.lexsort((lo[t], hi[t]))
        hi[t], lo[t] = hi[t][o], lo[t][o]
        hi[t, m[t]:] = UMAX
        lo[t, m[t]:] = UMAX
    return hi, lo


SHAPES = {"dups": (16, 24, None), "equal_across": (16, 20, None),
          "all_pad": (16, 8, None), "S_not_pow2": (5, 37, None),
          "T_not_mult16": (21, 16, None),
          "out_width_below_2S": (16, 20, 13), "S_1": (9, 1, None),
          "S_odd": (5, 37, 61), "one_key": (16, 20, None),
          "two_tiles": (2, 1030, 2055)}
KINDS = list(SHAPES)


def case(kind, seed=0):
    rng = np.random.default_rng(seed)
    T, S, ow = SHAPES[kind]
    m_a = rng.integers(0, S + 1, T)
    m_b = rng.integers(0, S + 1, T)
    if kind == "all_pad":
        m_a[::2] = 0
        m_b[:] = 0
        m_a[1] = 1  # a one-entry row
    if kind in ("one_key", "two_tiles"):
        m_a[:] = S
    a = sorted_rows(rng, T, S, m_a)
    b = (a[0].copy(), a[1].copy()) if kind == "equal_across" \
        else sorted_rows(rng, T, S, m_b)
    if kind == "one_key":  # full rows of one key repeated, in b too
        a[0][:] = rng.choice(HI_VALUES, (T, 1))
        a[1][:] = 3
        b[0][::2] = a[0][::2]
        b[1][::2] = 3
    return a, b, ow


@functools.lru_cache(maxsize=None)
def pallas_merge(kind):
    (a0, a1), (b0, b1), ow = case(kind)
    out = merge2_pallas(jnp.asarray(a0), jnp.asarray(a1), jnp.asarray(b0),
                        jnp.asarray(b1), interpret=True, out_width=ow)
    return tuple(np.asarray(o) for o in out)


def as_i32(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("kind", KINDS)
def test_merge2_ref_matches_pallas(kind):
    (a0, a1), (b0, b1), ow = case(kind)
    want = pallas_merge(kind)
    got = merge2_ref(as_i32(a0), as_i32(a1), as_i32(b0), as_i32(b1), ow)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))
    assert got[0].shape == (a0.shape[0], ow or 2 * a0.shape[1])


def test_merge2_wrapper_plain_on_cpu():
    (a0, a1), (b0, b1), _ = case("dups", seed=3)
    args = [as_i32(x) for x in (a0, a1, b0, b1)]
    before = merge2.launches
    for g, w in zip(merge2(*args, out_width=30), merge2_ref(*args, 30)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert merge2.launches == before
    with pytest.raises(ValueError):
        merge2(*args, out_width=2 * a0.shape[1] + 1)


def tiled_merge(a0, a1, b0, b1, ow, W, threads):
    """Python model of csrc/merge.cu's partition: the row's outputs cut
    into tiles of W at merge_path_split points, a tile's slices a[i0, i1),
    b[j0, j1) cut into ``threads`` runs of ceil(W / threads) outputs, each
    from its own diagonal's split inside the slices and merged by two
    pointers (a first on equal keys).  Every (tile, thread) at once."""
    T, S = a0.shape
    ntiles = -(-ow // W)
    P = -(-W // threads)
    row = torch.arange(T).repeat_interleave(ntiles)
    d0 = (torch.arange(ntiles) * W).repeat(T)
    d1 = (d0 + W).clamp(max=ow)
    rows = [x[row] for x in (a0, a1, b0, b1)]
    i0, j0 = merge_path_split(*rows, d0)
    i1, j1 = merge_path_split(*rows, d1)
    la, lb, n = i1 - i0, j1 - j0, d1 - d0
    assert bool(((la + lb) == n).all()) and int(n.min()) > 0
    cols = torch.arange(max(1, min(W, S)))
    sa = [x.gather(1, (i0[:, None] + cols).clamp(max=S - 1))
          for x in rows[:2]]
    sb = [x.gather(1, (j0[:, None] + cols).clamp(max=S - 1))
          for x in rows[2:]]
    tile = torch.arange(len(row)).repeat_interleave(threads)
    k0 = (torch.arange(threads) * P).repeat(len(row))
    keep = k0 < n[tile]
    tile, k0 = tile[keep], k0[keep]
    la, lb, n = la[tile], lb[tile], n[tile]
    ia, ib = merge_path_split(sa[0][tile], sa[1][tile], sb[0][tile],
                              sb[1][tile], k0, la, lb)
    assert bool(((ia + ib) == k0).all())
    ka, kb = pack_keys(*sa)[tile], pack_keys(*sb)[tile]
    last = len(cols) - 1
    out = torch.zeros((T, ow), dtype=torch.int64)
    filled = torch.zeros((T, ow), dtype=torch.int64)
    flat = row[tile] * ow + d0[tile] + k0  # each thread's first output
    for t in range(min(P, int(n.max()))):
        va = ka.gather(1, ia.clamp(max=last)[:, None])[:, 0]
        vb = kb.gather(1, ib.clamp(max=last)[:, None])[:, 0]
        take_a = (ib >= lb) | ((ia < la) & (va <= vb))
        live = k0 + t < n
        out.view(-1)[flat[live] + t] = torch.where(take_a, va, vb)[live]
        filled.view(-1)[flat[live] + t] += 1
        ia, ib = ia + take_a, ib + ~take_a
    assert bool((filled == 1).all())  # every output once
    return unpack_keys(out)


@pytest.mark.parametrize("threads", [1, 7, 256])
@pytest.mark.parametrize("width", ["1", "7", "2048", "wider"])
@pytest.mark.parametrize("kind", KINDS)
def test_merge_path_tiles_match_ref_and_pallas(kind, width, threads):
    (a0, a1), (b0, b1), ow = case(kind)
    args = [as_i32(x) for x in (a0, a1, b0, b1)]
    ow = ow or 2 * a0.shape[1]
    W = 2 * a0.shape[1] + 3 if width == "wider" else int(width)
    got = tiled_merge(*args, ow, W, threads)
    for g, r, p in zip(got, merge2_ref(*args, ow), pallas_merge(kind)):
        np.testing.assert_array_equal(g.numpy(), r.numpy())
        np.testing.assert_array_equal(g.numpy().view(np.uint32), p)


def test_merge_path_split_brute_force():
    """Each diagonal's split counts the a keys among the first d keys of
    a stable merge (a first on ties), on rows with duplicates across a
    and b."""
    (a0, a1), (b0, b1), _ = case("equal_across", seed=5)
    args = [as_i32(x) for x in (a0, a1, b0, b1)]
    T, S = a0.shape
    ka, kb = pack_keys(*args[:2]), pack_keys(*args[2:])
    src = torch.cat([torch.zeros(T, S, dtype=torch.int64),
                     torch.ones(T, S, dtype=torch.int64)], 1)
    order = torch.sort(torch.cat([ka, kb], 1), dim=1, stable=True).indices
    from_a = (src.gather(1, order) == 0).cumsum(1)
    for d in range(2 * S + 1):
        i, j = merge_path_split(*args, d)
        want = from_a[:, d - 1] if d else torch.zeros(T, dtype=torch.int64)
        assert torch.equal(i, want) and torch.equal(i + j,
                                                    torch.full((T,), d))
