"""Carry a sketch store across from the JAX package.

MHAP has no weights: its state is the sketch store.  ``store_from_jax``
takes the JAX ``SketchStore`` columns as numpy arrays (for example
``np.asarray(store.dev("minhash"))``) and builds the port's store, so the
port's vote and scorer can be held against the JAX package on identical
sketches, independently of sketching.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .overlapper import SketchStore


def store_from_jax(header_id, is_fwd, length, minhash, ordered_h, ordered_p,
                   ordered_m, num_kmers, headers=None,
                   device="cuda") -> SketchStore:
    dev = resolve_device(device)

    def col(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)

    return SketchStore(header_id, is_fwd, length, col(minhash),
                       col(ordered_h), col(ordered_p), col(ordered_m),
                       col(num_kmers), headers=headers)
