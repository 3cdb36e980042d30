"""Plain PyTorch version of kernel 6, the bit-sketch similarity matrix
(csrc/bits.cu, wrapper ops/bits_kernels.py), which replaces
mhap_tpu/sketches/bits.py:137 ``bit_similarity_matrix`` (a
``jax.lax.population_count``, not a Pallas kernel).

For ``a`` [NA, W] and ``b`` [NB, W] words of b = 32 or 64 bits:

    out[i, j] = 1 - float32(popcount(a[i] ^ b[j]) summed over W)
                    / float32(b * W)

in float32, IEEE round-to-nearest at the divide and the subtract, as the
JAX expression computes it: bit-equal to JAX on uint32 words, and on
uint64 words ``BitSketch.similarity`` rounded to float32.  Words travel
as int32 or int64 tensors with the same bits (``words``), since PyTorch's
unsigned types have few operations.

PyTorch has no popcount op, so this version gathers a 256-entry byte
table over the bytes of the xor, a chunk of A's rows at a time: exact,
but it materialises [rows, NB, 8W] bytes and is for tests and the card's
comparison only.
"""

from __future__ import annotations

import numpy as np
import torch

WORD_BITS = {torch.int32: 32, torch.int64: 64}
_SIGNED = {torch.uint32: torch.int32, torch.uint64: torch.int64}
_POPCOUNT8 = [bin(i).count("1") for i in range(256)]
CHUNK_BYTES = 1 << 24  # xor bytes a chunk of the plain version


def words(x, device) -> torch.Tensor:
    """numpy array or tensor [N, W] of uint32 or uint64 words -> a
    contiguous int32 or int64 tensor with the same bits on ``device``."""
    if isinstance(x, np.ndarray) and x.dtype in (np.uint32, np.uint64):
        x = torch.from_numpy(np.ascontiguousarray(x))
    if not isinstance(x, torch.Tensor) or x.dtype not in _SIGNED:
        raise TypeError("want uint32 or uint64 words, got "
                        f"{getattr(x, 'dtype', type(x))}")
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"want [N, W] words with W >= 1, got "
                         f"{tuple(x.shape)}")
    return x.view(_SIGNED[x.dtype]).to(device).contiguous()


def check_pair(a: torch.Tensor, b: torch.Tensor) -> int:
    """The bits a word of ``a`` and ``b`` ([NA, W], [NB, W], one dtype
    of WORD_BITS, one device); raise on anything else."""
    if a.dtype != b.dtype or a.dtype not in WORD_BITS:
        raise TypeError(f"want int32 or int64 words of one dtype, got "
                        f"{a.dtype} and {b.dtype}")
    if (a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[1]
            or a.shape[1] < 1):
        raise ValueError(f"want [NA, W] and [NB, W] with W >= 1, got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    return WORD_BITS[a.dtype]


def xor_popcount_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 [NA, NB]: popcount(a[i] ^ b[j]) summed over the words."""
    check_pair(a, b)
    na, nb = a.shape[0], b.shape[0]
    table = torch.tensor(_POPCOUNT8, dtype=torch.int32, device=a.device)
    out = torch.empty((na, nb), dtype=torch.int32, device=a.device)
    row_bytes = max(1, nb * a.shape[1] * a.element_size())
    step = max(1, CHUNK_BYTES // row_bytes)
    for r in range(0, na, step):
        x = a[r:r + step, None, :] ^ b[None, :, :]
        by = x.contiguous().view(torch.uint8)  # [rows, NB, W * bytes]
        out[r:r + step] = table[by.long()].sum(-1, dtype=torch.int32)
    return out


def bit_similarity_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 [NA, NB] similarity of int32 or int64 words (``words``):
    1 - count / nbits, each step rounded as JAX rounds it (tensor
    operands throughout: a Python scalar divisor may become a multiply by
    its reciprocal)."""
    nbits = check_pair(a, b) * a.shape[1]
    c = xor_popcount_ref(a, b).to(torch.float32)
    return torch.ones_like(c) - c / torch.full_like(c, float(nbits))
