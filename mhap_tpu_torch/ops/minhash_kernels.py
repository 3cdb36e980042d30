"""Wrappers of the CUDA min-reduce kernels (``csrc/minhash.cu``).

Kernel 1, ``min_reduce_w1``, replaces ``min_reduce_w1_pallas``
(mhap_tpu/ops/minhash_pallas.py:156); kernel 2, ``weighted_min_reduce``,
replaces ``weighted_min_reduce_pallas`` (:193).  For CPU tensors each
wrapper runs its plain version from ``ops/minhash.py``; for CUDA tensors
it launches the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build
from .minhash import min_reduce_w1_ref, weighted_min_reduce_ref


def _check_rows(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def _launch(h, weight, tiebreak, active, num_hashes: int, weighted: bool):
    B, n = h.shape
    _check_rows("h", h, torch.int64, (B, n), h.device)
    _check_rows("active", active, torch.uint8, (B, n), h.device)
    if weighted:
        _check_rows("weight", weight, torch.int32, (B, n), h.device)
        _check_rows("tiebreak", tiebreak, torch.int32, (B, n), h.device)
    out = torch.empty((B, num_hashes), dtype=torch.int32, device=h.device)
    lib = _build.kernels()
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    err = lib.mhap_min_reduce(
        h.data_ptr(), ptr(weight), ptr(tiebreak), active.data_ptr(), B, n,
        num_hashes, int(weighted), out.data_ptr(),
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "min_reduce")
    return out


def min_reduce_w1(h: torch.Tensor, active: torch.Tensor,
                  num_hashes: int) -> torch.Tensor:
    """Weight-1 min-reduce: h [B, n] int64, active [B, n] bool ->
    int32 [B, num_hashes]."""
    if h.device.type == "cpu":
        return min_reduce_w1_ref(h, active, num_hashes)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    out = _launch(h.contiguous(), None, None,
                  active.to(torch.uint8).contiguous(), num_hashes, False)
    min_reduce_w1.launches += 1
    return out


def weighted_min_reduce(h: torch.Tensor, weight: torch.Tensor,
                        active: torch.Tensor, tiebreak: torch.Tensor,
                        num_hashes: int) -> torch.Tensor:
    """Weighted min-reduce, lexicographic (value, tiebreak) arg-min:
    h [B, n] int64, weight/tiebreak [B, n] int32, active [B, n] bool ->
    int32 [B, num_hashes].  Any weight and width."""
    if h.device.type == "cpu":
        return weighted_min_reduce_ref(h, weight, active, tiebreak,
                                       num_hashes)
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")
    out = _launch(h.contiguous(), weight.to(torch.int32).contiguous(),
                  tiebreak.to(torch.int32).contiguous(),
                  active.to(torch.uint8).contiguous(), num_hashes, True)
    weighted_min_reduce.launches += 1
    return out


min_reduce_w1.launches = 0
weighted_min_reduce.launches = 0
