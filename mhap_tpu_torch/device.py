"""Device resolution for the port (counterpart of the
``jax.default_backend()`` checks in mhap_tpu/pipeline/overlapper.py).

A requested CUDA device that is absent raises: nothing moves to the CPU
on its own.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a ``torch.device`` (a CUDA device with its
    index, as tensors report it); raise if it is CUDA and no GPU is
    visible."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA GPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
