"""Wrapper of the CUDA Smith-Waterman kernel (``csrc/swalign.cu``), kernel
5, which replaces mhap_tpu/ops/swalign.py ``sw_align_batch`` (a
``jax.lax.scan``).

For CPU tensors the wrapper runs the plain version ``ops/swalign.
sw_align_batch``; for CUDA tensors it launches the kernel or raises.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build
from .swalign import COLS, sw_align_batch as sw_align_batch_ref

THREADS = 128  # a block; rows of a stripe
BORDER_FIELDS = 10  # int32s a column of a stripe's top row


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
        per_block = (m + 1) * BORDER_FIELDS * 4
        grid = max(1, min(P, 65535, _build.WORKSPACE_BYTES // per_block))
        border = torch.empty(grid * per_block // 4, dtype=torch.int32,
                             device=dev)
        err = _build.kernels().mhap_sw_align_batch(
            q.data_ptr(), n, r.data_ptr(), m, qlen.data_ptr(),
            rlen.data_ptr(), P, match, mismatch, gap_open, gap_extend,
            THREADS, grid, border.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "sw_align_batch")
        sw_align_batch.launches += 1
    return dict(zip(COLS, out))


sw_align_batch.launches = 0
