"""MHAP's two sketches (reference sketch/MinHashSketch.java:51-179 and
sketch/BottomOverlapSketch.java:525-559) in plain PyTorch.

Stage 1, the weighted MinHash.  Each distinct k-mer of a read seeds a
xorshift64 stream (x ^= x << 21; x ^= x >>> 35; x ^= x << 4) with its
murmur3_128 identity hash and, for each of the H slots in turn, consumes
``weight`` stream values; the slot keeps the k-mer whose minimum over its
values is least as a signed 64-bit number, the k-mer that occurs first in
the read winning ties, and stores the low 32 bits of that k-mer's hash on
even slots and the high 32 on odd ones.  A k-mer's weight is its count in
the read, or its tf-idf weight under a filter file.

Stage 2, the ordered sketch: the murmur3_32 of every k-mer, sorted by
signed hash and then by position, its first min(S, n) (hash, position)
pairs kept.

Rows are taken in chunks of similar length, each as a dense [rows,
distinct k-mers] tensor; the few k-mers of weight above 1 step in a
compact tensor of their own, sorted by weight so that each further step
is a prefix.
"""

from __future__ import annotations

import numpy as np
import torch

from .murmur3 import M32, hash32_windows, hash128_windows, shr

I64 = torch.int64
I64_MAX = (1 << 63) - 1
CELLS = 1 << 24  # row x width cells of one chunk

_RC = bytes.maketrans(b"ACGTMRWSYKVHDBN", b"TGCAKYWSRMBDHVN")


def reverse_complement(seq: bytes) -> bytes:
    """utils/Utils.java rc() on upper-case IUPAC codes."""
    return seq.translate(_RC)[::-1]


def chunks(lens: np.ndarray, cells: int = CELLS):
    """Row indices in chunks of similar length, each at most ``cells``
    rows x longest row (a row alone may exceed it)."""
    order = np.argsort(lens, kind="stable")
    s = 0
    while s < len(order):
        e = s + 1
        while e < len(order) and (e + 1 - s) * lens[order[e]] <= cells:
            e += 1
        yield order[s:e]
        s = e


def code_rows(seqs, idx, device) -> tuple[torch.Tensor, torch.Tensor]:
    """[R, W] uint8 rows of seqs[idx] (zero past each end) and lengths."""
    lens = np.array([len(seqs[i]) for i in idx], np.int64)
    codes = np.zeros((len(idx), int(lens.max())), np.uint8)
    for r, i in enumerate(idx):
        codes[r, :lens[r]] = np.frombuffer(seqs[i], np.uint8)
    return (torch.from_numpy(codes).to(device),
            torch.from_numpy(lens).to(device))


def xorshift_(x: torch.Tensor, t: torch.Tensor) -> None:
    """One stream step of x in place (t: scratch of x's shape)."""
    torch.bitwise_left_shift(x, 21, out=t)
    x.bitwise_xor_(t)
    torch.bitwise_right_shift(x, 35, out=t)
    t.bitwise_and_((1 << 29) - 1)
    x.bitwise_xor_(t)
    torch.bitwise_left_shift(x, 4, out=t)
    x.bitwise_xor_(t)


def _distinct_kmers(h: torch.Tensor, nvalid: torch.Tensor):
    """Distinct k-mers of each row: (row, key, first position, count),
    grouped by row."""
    R, n = h.shape
    dev = h.device
    valid = torch.arange(n, device=dev)[None, :] < nvalid[:, None]
    row = torch.arange(R, device=dev)[:, None].expand(R, n)[valid]
    pos = torch.arange(n, device=dev)[None, :].expand(R, n)[valid]
    key = h[valid]
    o = torch.sort(key, stable=True).indices
    o = o[torch.sort(row[o], stable=True).indices]
    row, key, pos = row[o], key[o], pos[o]
    new = torch.ones_like(row, dtype=torch.bool)
    new[1:] = (row[1:] != row[:-1]) | (key[1:] != key[:-1])
    start = torch.nonzero(new).squeeze(1)
    count = torch.diff(start, append=torch.tensor([len(row)], device=dev))
    # a stable sort keeps positions ascending within a k-mer: the group's
    # first entry is its first occurrence
    return row[start], key[start], pos[start], count


def _minhash_chunk(codes, lens, k, H, weigh):
    h = hash128_windows(codes, k)
    R = h.shape[0]
    dev = h.device
    nvalid = (lens - k + 1).clamp(min=0)
    if bool((nvalid == 0).any()):
        raise ValueError("a read shorter than k")
    g_row, g_key, g_first, g_count = _distinct_kmers(h, nvalid)
    del h
    w = g_count if weigh is None else weigh(g_key, g_count)
    per_row = torch.bincount(g_row, minlength=R)
    col = (torch.arange(len(g_row), device=dev)
           - (torch.cumsum(per_row, 0) - per_row)[g_row])
    G = int(per_row.max())
    keys = torch.zeros((R, G), dtype=I64, device=dev)
    keys[g_row, col] = g_key
    first = torch.full((R, G), I64_MAX, dtype=I64, device=dev)
    first[g_row, col] = g_first
    pad = torch.ones((R, G), dtype=torch.bool, device=dev)
    pad[g_row, col] = False
    heavy = w > 1
    hw, o = torch.sort(w[heavy], descending=True)
    h_at = (g_row * G + col)[heavy][o]
    hx = g_key[heavy][o]
    steps = [int(c) for c in torch.bincount(hw)[1:].flip(0).cumsum(0)
             .flip(0)] if hx.numel() else []  # k-mers with weight > c
    x = keys.clone()
    t = torch.empty_like(x)
    ht = torch.empty_like(hx)
    hwm = torch.empty_like(hx)
    out = torch.empty((R, H), dtype=torch.int32, device=dev)
    for s in range(H):
        xorshift_(x, t)
        wm = torch.where(pad, I64_MAX, x)
        for c, m in enumerate(steps):
            seg = hx[:m]
            xorshift_(seg, ht[:m])
            if c == 0:
                hwm.copy_(seg)
            else:
                torch.minimum(hwm[:m], seg, out=hwm[:m])
        if steps:
            wm.view(-1)[h_at] = hwm
        least = wm.min(dim=1, keepdim=True).values
        win = torch.where(wm == least, first, I64_MAX).argmin(dim=1)
        wkey = keys.gather(1, win[:, None])[:, 0]
        half = wkey & M32 if s % 2 == 0 else shr(wkey, 32)
        out[:, s] = (half - ((half >> 31) << 32)).to(torch.int32)
    return out


def minhash_rows(seqs, k: int, H: int, device, weigh=None) -> torch.Tensor:
    """int32 [len(seqs), H] weighted MinHash sketches of byte strings;
    ``weigh(keys, counts)`` gives the int64 weights of distinct k-mers
    (their counts when None)."""
    lens = np.array([len(s) for s in seqs], np.int64)
    out = torch.empty((len(seqs), H), dtype=torch.int32, device=device)
    for idx in chunks(lens):
        codes, ln = code_rows(seqs, idx, device)
        out[torch.from_numpy(idx).to(device)] = _minhash_chunk(
            codes, ln, k, H, weigh)
    return out


def ordered_rows(seqs, k: int, S: int, device) -> list:
    """[(int32 [m, 2] (hash, position), number of k-mers)] of each byte
    string: its ordered sketch as BottomOverlapSketch keeps it."""
    lens = np.array([len(s) for s in seqs], np.int64)
    out = [None] * len(seqs)
    for idx in chunks(lens):
        codes, ln = code_rows(seqs, idx, device)
        h = hash32_windows(codes, k)
        n = h.shape[1]
        pos = torch.arange(n, device=device)
        nvalid = (ln - k + 1).clamp(min=0)
        key = (h.to(I64) << 32) | pos[None, :]
        key = torch.where(pos[None, :] < nvalid[:, None], key, I64_MAX)
        top = torch.sort(key, dim=1).values[:, :S].cpu()
        top = torch.stack([top >> 32, top & M32], dim=2).to(torch.int32)
        for r, (i, nk) in enumerate(zip(idx, nvalid.cpu().tolist())):
            out[i] = (top[r, :min(S, nk)].numpy(), nk)
    return out


def _member(x: torch.Tensor, sorted_set: torch.Tensor) -> torch.Tensor:
    i = torch.searchsorted(sorted_set, x).clamp_(max=len(sorted_set) - 1)
    return sorted_set[i] == x


def rows_with_halves(seqs, k: int, slots: torch.Tensor, device
                     ) -> np.ndarray:
    """Indices of the byte strings with a k-mer whose hash has its low 32
    bits among the even slots' values of ``slots`` (int32 [Q, H] sketches)
    or its high 32 bits among the odd slots' values: every row that can
    share a slot value with one of those sketches."""
    v = slots.to(I64) & M32
    even = torch.unique(v[:, 0::2]).to(device)
    odd = torch.unique(v[:, 1::2]).to(device)
    lens = np.array([len(s) for s in seqs], np.int64)
    hit = np.zeros(len(seqs), bool)
    for idx in chunks(lens):
        codes, ln = code_rows(seqs, idx, device)
        h = hash128_windows(codes, k)
        n = h.shape[1]
        valid = torch.arange(n, device=device)[None, :] < (ln - k + 1)[:, None]
        m = _member(h & M32, even) | _member(shr(h, 32), odd)
        hit[idx] = (m & valid).any(dim=1).cpu().numpy()
    return np.nonzero(hit)[0]
