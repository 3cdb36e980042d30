"""Wrapper of the CUDA bit-sketch similarity kernel (``csrc/bits.cu``),
kernel 6, which replaces mhap_tpu/sketches/bits.py:137
``bit_similarity_matrix`` (a ``jax.lax.population_count``).

For CPU tensors the wrapper runs the plain version ``ops/bits.
bit_similarity_ref``; for CUDA tensors it launches the kernel or raises.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from . import _build
from .bits import bit_similarity_ref, check_pair

TILE = 64  # output rows and columns a block (csrc/bits.cu kTile)


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
    if (na + TILE - 1) // TILE > 65535:
        raise ValueError(f"NA = {na} rows exceed the kernel's grid "
                         f"({65535 * TILE})")
    out = torch.empty((na, nb), dtype=torch.float32, device=dev)
    if na and nb:
        err = _build.kernels().mhap_bit_similarity(
            a.data_ptr(), b.data_ptr(), na, nb, w, bits, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "bit_similarity")
        bit_similarity.launches += 1
    return out


bit_similarity.launches = 0
