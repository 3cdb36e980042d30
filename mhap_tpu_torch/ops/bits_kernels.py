"""Wrapper of the CUDA bit-sketch similarity kernel (``csrc/bits.cu``),
kernel 6, which replaces mhap_tpu/sketches/bits.py:137
``bit_similarity_matrix`` (a ``jax.lax.population_count``).

For CPU tensors the wrapper runs the plain version ``ops/bits.
bit_similarity_ref``; for CUDA tensors it launches the kernel or raises.
``launches`` counts kernel launches; ``occupancy`` reports what the card
gives the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .bits import bit_similarity_ref, check_pair


def bit_similarity(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [NA, W], b [NB, W]: int32 or int64 words of one dtype
    (``ops/bits.words``).  Returns float32 [NA, NB]."""
    dev = a.device
    if dev.type == "cpu":
        return bit_similarity_ref(a, b)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    bits = check_pair(a, b)
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("want contiguous words")
    na, nb, w = a.shape[0], b.shape[0], a.shape[1]
    out = torch.empty((na, nb), dtype=torch.float32, device=dev)
    if na and nb:
        err = _build.kernels().mhap_bit_similarity(
            a.data_ptr(), b.data_ptr(), na, nb, w, bits, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "bit_similarity")
        bit_similarity.launches += 1
    return out


bit_similarity.launches = 0


def occupancy(vec: bool = True, table: bool = True) -> dict:
    """The registers a thread, static / dynamic shared bytes a block, local
    (spill) bytes a thread and resident blocks per SM of the kernel, as the
    CUDA runtime reports them, with its warps a block and a warp's output
    tile.  ``vec``: the kernel of 16-byte row loads (rows of a multiple of
    4 words of 32 bits, 16-byte aligned) or of 4-byte ones; ``table``: the
    kernel for rows of fewer than 8,192 bits (csrc/bits.cu kTableMax),
    which looks its outputs up by count, or the one that divides."""
    info = (ctypes.c_int * 8)()
    _build.check(_build.kernels().mhap_bit_similarity_occupancy(
        int(vec), int(table), ctypes.addressof(info)),
        "bit_similarity occupancy")
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "local_bytes", "blocks_per_sm", "warps", "tile_rows",
                     "tile_cols"), info))
