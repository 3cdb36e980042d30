"""Wrapper of the CUDA merge kernel (``csrc/merge.cu``), kernel 4, which
replaces ``merge2_pallas`` (mhap_tpu/ops/merge_pallas.py:117).

Like the Pallas kernel it has no caller on the overlap path.  For CPU
tensors the wrapper runs the plain version ``ops/merge.merge2_ref``; for
CUDA tensors it launches the kernel or raises.  ``launches`` counts
kernel launches; ``occupancy`` reports what the card gives the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .merge import merge2_ref, out_width_of


def merge2(a0: torch.Tensor, a1: torch.Tensor, b0: torch.Tensor,
           b1: torch.Tensor, out_width: int | None = None):
    """Merge sorted 2-limb rows: a0, a1, b0, b1 [T, S] int32 (uint32
    bits) -> (o0, o1) int32 [T, out_width], default 2S."""
    dev = a0.device
    if dev.type == "cpu":
        return merge2_ref(a0, a1, b0, b1, out_width)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    T, S = a0.shape
    for name, t in (("a0", a0), ("a1", a1), ("b0", b0), ("b1", b1)):
        if (t.dtype != torch.int32 or tuple(t.shape) != (T, S)
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name}: want contiguous int32 {(T, S)} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    ow = out_width_of(S, out_width)
    o0 = torch.empty((T, ow), dtype=torch.int32, device=dev)
    o1 = torch.empty((T, ow), dtype=torch.int32, device=dev)
    if T == 0 or ow == 0:
        return o0, o1
    err = _build.kernels().mhap_merge2(
        a0.data_ptr(), a1.data_ptr(), b0.data_ptr(), b1.data_ptr(), T, S,
        ow, o0.data_ptr(), o1.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "merge2")
    merge2.launches += 1
    return o0, o1


merge2.launches = 0


def occupancy(S: int, out_width: int | None = None) -> dict:
    """The registers a thread, static / dynamic shared bytes a block, local
    (spill) bytes a thread and resident blocks per SM of the kernel that
    merges rows of width S into out_width outputs, as the CUDA runtime
    reports them; ``path`` "bulk" (cp.async.bulk, rows 16-byte aligned) or
    "async" (4-byte cp.async), ``tile`` outputs and ``stages``."""
    info = (ctypes.c_int * 8)()
    _build.check(_build.kernels().mhap_merge2_occupancy(
        S, out_width_of(S, out_width), ctypes.addressof(info)),
        "merge2 occupancy")
    out = dict(zip(("registers", "static_smem", "dynamic_smem",
                    "local_bytes", "blocks_per_sm"), info[:5]))
    out.update(path=("async", "bulk")[info[5]], tile=info[6],
               stages=info[7])
    return out
