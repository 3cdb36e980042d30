"""Stage-1 weighted MinHash in PyTorch (counterpart of mhap_tpu/ops/minhash.py).

Parity target: sketch/MinHashSketch.java:51-179.  Each distinct k-mer of a
read seeds a xorshift64 stream with its 64-bit identity hash; for each of
the H sketch slots it consumes ``weight`` stream values, and the slot keeps
the k-mer whose window minimum is smallest as a signed 64-bit value (Java
``long``), the earliest-inserted k-mer winning ties.  The slot stores the
low half of the winner's hash on even slots and the high half on odd ones.

``min_reduce_w1_ref`` and ``weighted_min_reduce_ref`` are the plain PyTorch
versions of the two CUDA kernels in ``minhash_kernels.py``.  A row with no
active k-mer yields zeros (the pipeline drops such rows).  With a k-mer
filter, ``minhash_filtered_rows`` weights each distinct k-mer by the
filter (tf-idf or legacy) instead of by its count.  ``xorshift_jump_table``
is the table kernel 2's heavy pass jumps a stream with, and
``xorshift_jump`` the same jump in PyTorch.
"""

from __future__ import annotations

import torch

I64 = torch.int64
I32 = torch.int32
_I64_MAX = (1 << 63) - 1
_I32_MAX = (1 << 31) - 1
_SIGN = -(1 << 63)


def xorshift(x: torch.Tensor) -> torch.Tensor:
    """One step of the stream (MinHashSketch.java:139-142) on int64 bit
    patterns: x ^= x << 21; x ^= x >>> 35; x ^= x << 4."""
    x = x ^ (x << 21)
    x = x ^ ((x >> 35) & ((1 << 29) - 1))
    return x ^ (x << 4)


def slot_halves(keys: torch.Tensor) -> torch.Tensor:
    """[B, H] int64 winning hashes -> int32 sketch: low half on even
    slots, high half on odd slots (ops/minhash.py:177-178)."""
    lo = keys & 0xFFFFFFFF
    hi = (keys >> 32) & 0xFFFFFFFF
    even = (torch.arange(keys.shape[1], device=keys.device) % 2 == 0)
    v = torch.where(even[None, :], lo, hi)
    return (v - ((v >> 31) << 32)).to(I32)


JUMP_BITS = 48  # xorshift_jump_table rows: jumps of fewer than 2^48 steps


def _gf2_apply(cols: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """M·x over GF(2) for the 64x64 bit matrix M whose column b is
    cols[b] (int64 bit patterns): the XOR of the columns of x's set bits."""
    bit = torch.arange(64, device=x.device)
    v = torch.where(((x[..., None] >> bit) & 1).bool(), cols, 0)
    while v.shape[-1] > 1:
        v = v[..., 0::2] ^ v[..., 1::2]
    return v[..., 0]


def xorshift_jump_table() -> torch.Tensor:
    """int64 [JUMP_BITS, 64]: row i holds the columns of M^(2^i), where M
    is the xorshift step as a 64x64 bit matrix (the step is linear over
    GF(2)).  Row 0 is the step applied to each unit vector; row i+1 is
    row i squared."""
    rows = [xorshift(torch.tensor(1, dtype=I64) << torch.arange(64))]
    for _ in range(JUMP_BITS - 1):
        rows.append(_gf2_apply(rows[-1], rows[-1]))
    return torch.stack(rows)


def xorshift_jump(x: torch.Tensor, j, table: torch.Tensor) -> torch.Tensor:
    """``j`` xorshift steps of x in popcount(j) matrix products (the heavy
    pass of csrc/minhash.cu does the same); j an int or an int64 tensor
    broadcastable to x, 0 <= j < 2^JUMP_BITS."""
    j = torch.as_tensor(j, dtype=I64, device=x.device)
    table = table.to(x.device)
    for i in range(JUMP_BITS):
        take = ((j >> i) & 1).bool()
        if take.any():
            x = torch.where(take, _gf2_apply(table[i], x), x)
    return x


def weighted_argmin_ref(h: torch.Tensor, weight: torch.Tensor,
                        active: torch.Tensor, tiebreak: torch.Tensor,
                        num_hashes: int):
    """Per row and slot, the lexicographic (window minimum, tiebreak)
    arg-min over the active k-mers: (value int64, tiebreak int64, index
    int64), each [B, num_hashes]; a row with no active k-mer gives
    (INT64_MAX, INT32_MAX, -1)."""
    B, n = h.shape
    w = torch.where(active, weight.to(I64), 0)
    w_max = int(w.max()) if w.numel() else 0
    tb = torch.where(active, tiebreak.to(I64), _I32_MAX)
    x = h.clone()
    val = torch.full((B, num_hashes), _I64_MAX, dtype=I64, device=h.device)
    win_tb = torch.full_like(val, _I32_MAX)
    idx = torch.full_like(val, -1)
    any_active = active.any(dim=1)
    for s in range(num_hashes):
        wm = torch.full((B, n), _I64_MAX, dtype=I64, device=h.device)
        for t in range(w_max):
            nxt = xorshift(x)
            adv = t < w
            x = torch.where(adv, nxt, x)
            wm = torch.where(adv & (nxt < wm), nxt, wm)
        m = wm.min(dim=1, keepdim=True).values
        cand = active & (wm == m)
        sel = torch.where(cand, tb, _I64_MAX).argmin(dim=1)
        val[:, s] = torch.where(any_active, m[:, 0], _I64_MAX)
        win_tb[:, s] = torch.where(any_active, tb.gather(1, sel[:, None])[:, 0],
                                   _I32_MAX)
        idx[:, s] = torch.where(any_active, sel, -1)
    return val, win_tb, idx


def winner_halves(h: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Winning k-mer indices [B, H] (-1: none) -> int32 sketch of the
    winners' hashes (0 where none)."""
    keys = h.gather(1, idx.clamp(min=0))
    return slot_halves(torch.where(idx >= 0, keys, 0))


def weighted_min_reduce_ref(h: torch.Tensor, weight: torch.Tensor,
                            active: torch.Tensor, tiebreak: torch.Tensor,
                            num_hashes: int) -> torch.Tensor:
    """Plain version of the weighted kernel.

    h [B, n] int64 k-mer hashes, weight/tiebreak [B, n] int32, active
    [B, n] bool.  Argmin per slot is lexicographic on (window minimum,
    tiebreak).  Returns int32 [B, num_hashes]."""
    _, _, idx = weighted_argmin_ref(h, weight, active, tiebreak, num_hashes)
    return winner_halves(h, idx)


def min_reduce_w1_ref(h: torch.Tensor, active: torch.Tensor,
                      num_hashes: int) -> torch.Tensor:
    """Plain version of the weight-1 kernel: every active position steps
    once per slot.  Duplicate positions of one k-mer may all be active;
    they tie to the same stored key."""
    B, n = h.shape
    x = h.clone()
    keys = torch.zeros((B, num_hashes), dtype=I64, device=h.device)
    for s in range(num_hashes):
        x = xorshift(x)
        v = torch.where(active, x, _I64_MAX)
        sel = v.argmin(dim=1)
        keys[:, s] = h.gather(1, sel[:, None])[:, 0]
    keys = torch.where(active.any(dim=1, keepdim=True), keys, 0)
    return slot_halves(keys)


def sort_and_count(h: torch.Tensor, valid: torch.Tensor) -> dict:
    """Group duplicate k-mer hashes per row (ops/minhash.py:40).

    Sorted by (invalid, hash as unsigned 64-bit, position), like the JAX
    3-key sort.  Returns [B, n] tensors: ``h`` (sorted hashes), ``first``
    (first valid element of a run), ``count`` (run length, meaningful at
    ``first``) and ``tiebreak`` (original position, int32)."""
    B, n = h.shape
    # signed order of (h ^ sign bit) == unsigned order of h
    o1 = torch.sort(h ^ _SIGN, dim=1, stable=True).indices
    inval = (~valid).gather(1, o1).to(torch.uint8)
    o2 = torch.sort(inval, dim=1, stable=True).indices
    order = o1.gather(1, o2)
    s_h = h.gather(1, order)
    s_valid = valid.gather(1, order)
    prev_same = torch.zeros_like(s_valid)
    prev_same[:, 1:] = s_h[:, 1:] == s_h[:, :-1]
    first = s_valid & ~prev_same
    # run length = distance to the next run start (or the valid count)
    pos = torch.arange(n, device=h.device).expand(B, n)
    n_valid = s_valid.sum(dim=1, keepdim=True)
    nxt = torch.where(first, pos, n)
    nxt = torch.cat([nxt[:, 1:], torch.full((B, 1), n, device=h.device,
                                            dtype=nxt.dtype)], dim=1)
    nxt = torch.flip(torch.cummin(torch.flip(nxt, [1]), dim=1).values, [1])
    count = (torch.minimum(nxt, n_valid) - pos).to(I32)
    return {"h": s_h, "first": first, "count": count,
            "tiebreak": order.to(I32)}


def dup_rows(h: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Per-row flag: does a low-32-bit hash half repeat among valid
    positions (ops/minhash.py:78)?  One-sided: a repeated k-mer is never
    missed; a low-half collision only routes the row to the weighted
    kernel, which is exact for it too."""
    B, n = h.shape
    pos = torch.arange(n, device=h.device, dtype=I64).expand(B, n)
    k_lo = torch.where(valid, h & 0xFFFFFFFF, pos)
    s = torch.sort(k_lo, dim=1).values
    return (s[:, 1:] == s[:, :-1]).any(dim=1)


def minhash_weighted_rows(h: torch.Tensor, valid: torch.Tensor,
                          num_hashes: int, reduce_fn) -> torch.Tensor:
    """Exact tf-weighted sketch of rows with repeated k-mers: dedup by
    ``sort_and_count``, weight = occurrence count at each run's first
    element, first-occurrence position as the tiebreak (the reference's
    insertion-ordered map), reduced by ``reduce_fn`` (the weighted kernel
    wrapper or its plain version)."""
    g = sort_and_count(h, valid)
    w = torch.where(g["first"], g["count"], 0)
    active = g["first"] & (w > 0)
    return reduce_fn(g["h"], w, active, g["tiebreak"], num_hashes)


def minhash_filtered_rows(h: torch.Tensor, valid: torch.Tensor, weights,
                          num_hashes: int, reduce_fn):
    """Filtered sketch of every row (mhap_tpu/pipeline/overlapper.py
    ``_sketch_core`` filter branch :284-306): dedup by ``sort_and_count``,
    ``weights(keys, counts)`` (the filter's int32 weights) at each run's
    first element, ``active = first & (w > 0)``, then ``reduce_fn`` at
    those exact weights.  Returns (sketch int32 [B, num_hashes],
    n_active [B]); a row with no active k-mer is dropped by the caller."""
    g = sort_and_count(h, valid)
    w = torch.where(g["first"], weights(g["h"], g["count"]), 0)
    active = g["first"] & (w > 0)
    mh = reduce_fn(g["h"], w, active, g["tiebreak"], num_hashes)
    return mh, active.sum(dim=1)
