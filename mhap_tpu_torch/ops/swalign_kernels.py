"""Wrapper of the CUDA Smith-Waterman kernel (``csrc/swalign.cu``), kernel
5, which replaces mhap_tpu/ops/swalign.py ``sw_align_batch`` (a
``jax.lax.scan``).

For CPU tensors the wrapper runs the plain version ``ops/swalign.
sw_align_batch``; for CUDA tensors it launches the kernel or raises.
``launches`` counts kernel launches; ``occupancy`` reports what the card
gives the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .swalign import COLS, sw_align_batch as sw_align_batch_ref

# the block's shape, which ops/_build.py passes to nvcc
WARPS = 4  # a block: a team of warps that share a pair's stripes
LANES = 32  # a warp
ROWS = 4  # query rows a lane
STRIPE = LANES * ROWS  # query rows a warp sweeps at once
PACKED_MAX = 65535  # n + m of the two-word (16-bit field) path stats


def packed_stats(n: int, m: int, gap_open: int, gap_extend: int) -> bool:
    """Whether a [P, n] x [P, m] batch takes the kernel's two-word path
    stats: every field fits 16 bits (L <= n + m), and no gap penalty is
    negative (the stats of a zero cell then have no reader, so they are
    not zeroed).  Else it takes the 32-bit instantiation."""
    return n + m <= PACKED_MAX and gap_open >= 0 and gap_extend >= 0


_occupancy: dict = {}


def occupancy(wide: bool, device=None) -> dict:
    """The kernel's registers and local (spill) bytes a thread, resident
    blocks and warps an SM, as the CUDA runtime reports them for the
    two-word (``wide`` False) or 32-bit instantiation; with SMs and bytes
    a column of a warp's border row."""
    dev = torch.device(device or "cuda")
    key = (dev, bool(wide))
    if key not in _occupancy:
        info = (ctypes.c_int * 5)()
        with torch.cuda.device(dev):
            _build.check(_build.kernels().mhap_sw_align_occupancy(
                int(wide), ctypes.addressof(info)), "sw_align occupancy")
        out = dict(zip(("registers", "local_bytes", "blocks_per_sm", "sms",
                        "entry_bytes"), info))
        out["warps_per_sm"] = out["blocks_per_sm"] * WARPS
        _occupancy[key] = out
    return _occupancy[key]


def sw_align_batch(q: torch.Tensor, qlen: torch.Tensor, r: torch.Tensor,
                   rlen: torch.Tensor, *, match: int = 2, mismatch: int = -2,
                   gap_open: int = 2, gap_extend: int = 1) -> dict:
    """q: [P, n] uint8, r: [P, m] uint8 (padded); qlen, rlen: [P] int32.
    Returns a dict of [P] int32 tensors (ops/swalign.COLS)."""
    dev = q.device
    if dev.type == "cpu":
        return sw_align_batch_ref(q, qlen, r, rlen, match=match,
                                  mismatch=mismatch, gap_open=gap_open,
                                  gap_extend=gap_extend)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    P, n = q.shape
    m = r.shape[1]
    for name, t, dtype, shape in (("q", q, torch.uint8, (P, n)),
                                  ("r", r, torch.uint8, (P, m)),
                                  ("qlen", qlen, torch.int32, (P,)),
                                  ("rlen", rlen, torch.int32, (P,))):
        if (t.dtype != dtype or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name}: want contiguous {dtype} {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    out = torch.empty((len(COLS), P), dtype=torch.int32, device=dev)
    if P:
        wide = not packed_stats(n, m, gap_open, gap_extend)
        occ = occupancy(wide, dev)
        # a block takes a pair at a time; a warp has its border row
        per_block = WARPS * (m + 2) * occ["entry_bytes"]
        grid = max(1, min(P, occ["blocks_per_sm"] * occ["sms"],
                          _build.WORKSPACE_BYTES // per_block))
        border = torch.empty(grid * per_block, dtype=torch.uint8,
                             device=dev)
        # the largest pairs first
        cells = qlen.clamp(0, n).long() * rlen.clamp(0, m).long()
        order = torch.argsort(cells, descending=True, stable=True).to(
            torch.int32)
        nxt = torch.zeros(1, dtype=torch.int32, device=dev)
        err = _build.kernels().mhap_sw_align_batch(
            q.data_ptr(), n, r.data_ptr(), m, qlen.data_ptr(),
            rlen.data_ptr(), order.data_ptr(), P, match, mismatch, gap_open,
            gap_extend, int(wide), grid, border.data_ptr(), nxt.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "sw_align_batch")
        sw_align_batch.launches += 1
    return dict(zip(COLS, out))


sw_align_batch.launches = 0
