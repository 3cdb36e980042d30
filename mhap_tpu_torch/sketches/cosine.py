"""Random-hyperplane (cosine-distance) LSH sketch (the port's copy of
mhap_tpu/sketches/cosine.py).

Parity target: sketch/CosineDistanceSketch.java (:40-64): each bit is the
sign of the dot product of the input vector with a Gaussian random vector
seeded per (word, bit).  The reference draws its Gaussians from a
strictfp MersenneTwisterFast (utils/MersenneTwisterFast.java) seeded with
``seed+(word+1)*bit``; this rebuild uses numpy's MT19937 with the same
per-bit seeding scheme -- the generator differs (documented divergence:
the component is dead code in the reference, nothing consumes its
output), but the LSH property (P[bits equal] = 1 - angle/pi) is identical.
"""

from __future__ import annotations

import numpy as np

from .bits import BitSketch


def random_gaussian_vector(length: int, seed: int) -> np.ndarray:
    """Unit-norm Gaussian vector (HashUtils.randomGuassianVector :260-305)."""
    rng = np.random.Generator(np.random.MT19937(seed & 0xFFFFFFFF))
    v = rng.standard_normal(length)
    n = np.linalg.norm(v)
    return v / n if n > 0 else v


class CosineDistanceSketch(BitSketch):
    def __init__(self, vector: np.ndarray, num_words: int, seed: int):
        vector = np.asarray(vector, np.float64)
        bits = np.zeros(num_words, np.uint64)
        for word in range(num_words):
            cur = 0
            for bit in range(64):
                rvec = random_gaussian_vector(len(vector),
                                              seed + (word + 1) * bit)
                if float(vector @ rvec) > 0.0:
                    cur |= 1 << bit
            bits[word] = cur
        super().__init__(bits)
