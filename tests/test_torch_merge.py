"""Kernel 4's plain version (ops/merge.merge2_ref) against the Pallas
``merge2_pallas`` in interpret mode, on the same numpy rows: sorted 2-limb
uint32 keys with pads (0xFFFFFFFF, 0xFFFFFFFF) in the suffix.  All
outputs are integers, so every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhap_tpu.ops.merge_pallas import merge2_pallas
from mhap_tpu_torch.ops.merge import merge2_ref
from mhap_tpu_torch.ops.merge_kernels import merge2

UMAX = np.uint32(0xFFFFFFFF)
# high limbs around the sign bit and the top, so that signed and
# unsigned orders differ
HI_VALUES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                      0xFFFFFFFF], np.uint32)


def sorted_rows(rng, T, S, m):
    """[T, S] limb pairs, row t sorted with its first m[t] entries real
    (values from small spaces: duplicate keys) and pads after."""
    hi = rng.choice(HI_VALUES, (T, S))
    lo = rng.choice(np.array([0, 3, 0x80000000, 0xFFFFFFFF], np.uint32),
                    (T, S))
    for t in range(T):
        o = np.lexsort((lo[t], hi[t]))
        hi[t], lo[t] = hi[t][o], lo[t][o]
        hi[t, m[t]:] = UMAX
        lo[t, m[t]:] = UMAX
    return hi, lo


def case(kind, seed=0):
    rng = np.random.default_rng(seed)
    T, S, ow = {"dups": (16, 24, None), "equal_across": (16, 20, None),
                "all_pad": (16, 8, None), "S_not_pow2": (5, 37, None),
                "T_not_mult16": (21, 16, None),
                "out_width_below_2S": (16, 20, 13)}[kind]
    m_a = rng.integers(0, S + 1, T)
    m_b = rng.integers(0, S + 1, T)
    if kind == "all_pad":
        m_a[::2] = 0
        m_b[:] = 0
        m_a[1] = 1  # a one-entry row
    a = sorted_rows(rng, T, S, m_a)
    b = (a[0].copy(), a[1].copy()) if kind == "equal_across" \
        else sorted_rows(rng, T, S, m_b)
    return a, b, ow


def as_i32(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


@pytest.mark.parametrize("kind", ["dups", "equal_across", "all_pad",
                                  "S_not_pow2", "T_not_mult16",
                                  "out_width_below_2S"])
def test_merge2_ref_matches_pallas(kind):
    (a0, a1), (b0, b1), ow = case(kind)
    want = merge2_pallas(jnp.asarray(a0), jnp.asarray(a1), jnp.asarray(b0),
                         jnp.asarray(b1), interpret=True, out_width=ow)
    got = merge2_ref(as_i32(a0), as_i32(a1), as_i32(b0), as_i32(b1), ow)
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      np.asarray(w))
    assert got[0].shape == (a0.shape[0], ow or 2 * a0.shape[1])


def test_merge2_wrapper_plain_on_cpu():
    (a0, a1), (b0, b1), _ = case("dups", seed=3)
    args = [as_i32(x) for x in (a0, a1, b0, b1)]
    before = merge2.launches
    for g, w in zip(merge2(*args, out_width=30), merge2_ref(*args, 30)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert merge2.launches == before
    with pytest.raises(ValueError):
        merge2(*args, out_width=2 * a0.shape[1] + 1)
