"""Stage-2 bottom-k (hash, position) sketch (counterpart of
mhap_tpu/ops/bottomk.py).

Parity target: sketch/BottomOverlapSketch.java:525-559 -- murmur3_32 every
k-mer, sort by signed hash then position, keep the bottom
min(sketch_size, n) entries.  One int64 key per window packs
(hash << 32 | position); invalid windows take INT64_MAX, above every valid
key, so one sort orders rows by (invalid, hash, position) exactly.
Entries past a read's count are PAD sentinels.
"""

from __future__ import annotations

import torch

PAD_HASH = 0x7FFFFFFF
PAD_POS = 0x7FFFFFFF
_I64_MAX = (1 << 63) - 1


def bottom_sketch(hashes: torch.Tensor, valid: torch.Tensor,
                  sketch_size: int):
    """hashes [B, n] int32, valid [B, n] bool.

    Returns (hash int32 [B, S], pos int32 [B, S], m int32 [B]) with
    S = sketch_size; entries >= m[b] are PAD sentinels."""
    B, n = hashes.shape
    pos = torch.arange(n, device=hashes.device, dtype=torch.int64)
    key = (hashes.to(torch.int64) << 32) | pos[None, :]
    key = torch.where(valid, key, _I64_MAX)
    S = min(sketch_size, n)
    top = torch.sort(key, dim=1).values[:, :S]
    m = torch.clamp(valid.sum(dim=1), max=S).to(torch.int32)
    in_range = torch.arange(S, device=hashes.device)[None, :] < m[:, None]
    out_h = torch.where(in_range, (top >> 32).to(torch.int32), PAD_HASH)
    out_p = torch.where(in_range, (top & 0xFFFFFFFF).to(torch.int32),
                        PAD_POS)
    if S < sketch_size:
        pad = (0, sketch_size - S)
        out_h = torch.nn.functional.pad(out_h, pad, value=PAD_HASH)
        out_p = torch.nn.functional.pad(out_p, pad, value=PAD_POS)
    return out_h.to(torch.int32), out_p.to(torch.int32), m
