"""Merge of two per-row sorted 2-limb key rows (counterpart of
mhap_tpu/ops/merge_pallas.py ``merge2_pallas``), plain PyTorch version.

A key is the unsigned 64-bit value (limb0 << 32 | limb1).  Torch lacks
most uint32 operations, so the limbs travel bit for bit in int32 tensors
(a uint32 array viewed as int32).  Pads are (0xFFFFFFFF, 0xFFFFFFFF), the
largest key.

Precondition, as for the Pallas kernel: each row of ``a`` and of ``b`` is
sorted ascending with its pads in the suffix.  The output is the first
``out_width`` keys of the sorted union of the two rows: a multiset of whole
keys with no payload, so any correct merge gives these bits.

``merge_path_split`` gives the points where the CUDA kernel
(``csrc/merge.cu``) cuts a merged row into tiles and a tile into each
thread's outputs; only tests use it here.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_SIGN = -(1 << 63)


def pack_keys(limb0: torch.Tensor, limb1: torch.Tensor) -> torch.Tensor:
    """int32 limb pairs -> int64 keys whose signed order is the unsigned
    order of (limb0, limb1)."""
    k = ((limb0.to(torch.int64) & _M32) << 32) | (limb1.to(torch.int64)
                                                  & _M32)
    return k ^ _SIGN


def unpack_keys(keys: torch.Tensor):
    """Inverse of ``pack_keys``: (limb0, limb1) int32."""
    k = keys ^ _SIGN
    hi = (k >> 32) & _M32
    lo = k & _M32
    return ((hi - ((hi >> 31) << 32)).to(torch.int32),
            (lo - ((lo >> 31) << 32)).to(torch.int32))


def out_width_of(S: int, out_width) -> int:
    ow = 2 * S if out_width is None else int(out_width)
    if not 0 <= ow <= 2 * S:
        raise ValueError(f"out_width {ow} outside [0, {2 * S}]")
    return ow


def merge2_ref(a0: torch.Tensor, a1: torch.Tensor, b0: torch.Tensor,
               b1: torch.Tensor, out_width: int | None = None):
    """a0, a1, b0, b1: [T, S] int32 limbs of sorted rows.  Returns (o0, o1)
    int32 [T, out_width] (default 2S): the smallest keys of the union."""
    T, S = a0.shape
    ow = out_width_of(S, out_width)
    keys = torch.cat([pack_keys(a0, a1), pack_keys(b0, b1)], dim=1)
    return unpack_keys(torch.sort(keys, dim=1).values[:, :ow])


def merge_path_split(a0: torch.Tensor, a1: torch.Tensor, b0: torch.Tensor,
                     b1: torch.Tensor, diag, a_len=None, b_len=None):
    """The merge path's split of each row pair at output diagonal ``diag``
    (an int or a [T] tensor): (i, j) int64 [T] with i + j = diag, the
    numbers of a's and b's keys among the first diag keys of the merged
    row, equal keys a before b.  i is the least index in [max(0, diag -
    b_len), min(diag, a_len)] with a[i] > b[diag - 1 - i], else the upper
    end.  ``a_len``, ``b_len`` ([T], default the width) bound rows that
    hold a shorter slice, as a tile's do in the kernel."""
    T, S = a0.shape
    ka, kb = pack_keys(a0, a1), pack_keys(b0, b1)
    d = torch.as_tensor(diag, dtype=torch.int64).expand(T)
    la = torch.full((T,), S) if a_len is None else a_len.to(torch.int64)
    lb = torch.full((T,), S) if b_len is None else b_len.to(torch.int64)
    lo = (d - lb).clamp(min=0)
    hi = torch.minimum(d, la)
    for _ in range(S.bit_length()):  # ceil(log2(S + 1)) halvings
        active = lo < hi
        mid = (lo + hi) // 2
        va = ka.gather(1, mid.clamp(0, S - 1)[:, None])[:, 0]
        vb = kb.gather(1, (d - 1 - mid).clamp(0, S - 1)[:, None])[:, 0]
        later = va > vb
        hi = torch.where(active & later, mid, hi)
        lo = torch.where(active & ~later, mid + 1, lo)
    return lo, d - lo
