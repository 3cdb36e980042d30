"""The port's scorer (plain version of the CUDA kernel) on the CPU against
``score_pairs_pallas`` (interpret mode) and the oracle automaton.

The pair generators are those of tests/test_scorer_pallas.py.  The TPU
kernel escalates lanes its scan model cannot reproduce; on every other
lane all integer columns must be equal.  Against the oracle
(``get_overlap_info``) every lane must agree.  Exact comparisons
throughout: the outputs are integers, and the identity is computed once
on the host from (inter, k).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhap_tpu.ops import scorer as K
from mhap_tpu.ops.scorer_pallas import (reverse_sketch_rows,
                                        score_pairs_pallas)
from mhap_tpu.oracle import scorer as osc
from mhap_tpu_torch.ops.scorer import COLS, score_pairs_ref
from mhap_tpu_torch.ops.scorer_kernels import score_pairs

# one intra-op thread: the plain kernels run many small tensor ops,
# whose thread pools stall for seconds each when test processes
# share the cores
torch.set_num_threads(1)


def _mk_side(rng, S, nk, hashes):
    m = min(S, max(3, nk))
    h = hashes[:m]
    p = rng.integers(0, nk, m).astype(np.int32)
    order = np.lexsort((p, h))
    oh = np.full(S, 0x7FFFFFFF, np.int32)
    op = np.full(S, 0x7FFFFFFF, np.int32)
    oh[:m] = h[order]
    op[:m] = p[order]
    return oh, op, m


def _gen(rng, S, T, nval_lo, nval_hi, overlap_frac=0.0):
    """tests/test_scorer_pallas.py's pair generator."""
    A = dict(h=[], p=[], m=[], nk=[])
    Bd = dict(h=[], p=[], m=[], nk=[])
    for _ in range(T):
        nk1 = int(rng.integers(10, 3 * S))
        nk2 = int(rng.integers(10, 3 * S))
        nvals = int(rng.integers(nval_lo, nval_hi))
        m1, m2 = min(S, nk1), min(S, nk2)
        if overlap_frac:
            pool = rng.integers(-2**31, 2**31 - 1, m1 + m2,
                                dtype=np.int64).astype(np.int32)
            nsh = int(overlap_frac * min(m1, m2))
            h1 = pool[:m1]
            h2 = np.concatenate([pool[:nsh], pool[m1:m1 + m2 - nsh]])
        else:
            h1 = rng.integers(-nvals, nvals, m1).astype(np.int32)
            h2 = rng.integers(-nvals, nvals, m2).astype(np.int32)
        for side, (h, nk) in ((A, (h1, nk1)), (Bd, (h2, nk2))):
            oh, op, m = _mk_side(rng, S, nk, h)
            side["h"].append(oh)
            side["p"].append(op)
            side["m"].append(m)
            side["nk"].append(nk)
    return ([np.stack(A["h"]), np.stack(A["p"]),
             np.array(A["m"], np.int32), np.array(A["nk"], np.int32)],
            [np.stack(Bd["h"]), np.stack(Bd["p"]),
             np.array(Bd["m"], np.int32), np.array(Bd["nk"], np.int32)])


# (seed, S, T, nval_lo, nval_hi, overlap_frac): tiny hash spaces force
# deep duplicate runs and shift retries; wide ones are the real regime
CASES = {
    "adversarial": (7, 64, 96, 4, 60, 0.0),
    "overlapping": (11, 128, 128, 2**30, 2**31, 0.3),
    "disjoint": (3, 64, 32, 2**30, 2**31, 0.0),
    "tiny_space": (19, 64, 64, 3, 30, 0.0),
}


def _ref(a, b):
    return score_pairs_ref(*[torch.from_numpy(x) for x in a + b],
                           0.2).numpy()


@pytest.mark.parametrize("case", ["adversarial", "overlapping"])
def test_ref_matches_pallas_on_unescalated_lanes(case):
    seed, S, T, lo, hi, frac = CASES[case]
    a, b = _gen(np.random.default_rng(seed), S, T, lo, hi, frac)
    got = _ref(a, b)
    bhr, bpr = reverse_sketch_rows(b[0], b[1], b[2])
    out = score_pairs_pallas(
        *[jnp.asarray(x) for x in a],
        jnp.asarray(np.ascontiguousarray(bhr)),
        jnp.asarray(np.ascontiguousarray(bpr)), jnp.asarray(b[2]),
        jnp.asarray(b[3]), max_shift_mul=K.fixed_point_constant(0.2),
        sketch_size=S, interpret=True)
    lanes = ~np.asarray(out["needs_slow"])
    assert lanes.sum() >= 10
    for j, name in enumerate(COLS):
        if name == "escal":
            continue
        np.testing.assert_array_equal(
            got[lanes, j], np.asarray(out[name])[lanes].astype(np.int64),
            err_msg=name)
    assert not got[:, COLS.index("escal")].any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_ref_matches_oracle_on_all_lanes(case):
    seed, S, T, lo, hi, frac = CASES[case]
    a, b = _gen(np.random.default_rng(seed), S, T, lo, hi, frac)
    got = _ref(a, b)
    for t in range(T):
        s1 = np.stack([a[0][t, :a[2][t]], a[1][t, :a[2][t]]], 1)
        s2 = np.stack([b[0][t, :b[2][t]], b[1][t, :b[2][t]]], 1)
        want = osc.get_overlap_info(s1, int(a[3][t]), s2, int(b[3][t]), 12,
                                    0.2)
        row = got[t]
        if not row[0]:
            assert want == osc.EMPTY, t
            continue
        ident = osc.jaccard_to_identity(row[1] / max(row[2], 1), 12)
        assert (ident, float(row[3]), *row[4:8].tolist()) == want, t
    if case == "disjoint":
        assert not got[:, 0].any()
    else:
        assert got[:, 0].sum() > T // 4


def test_wrapper_gathers_rows_on_cpu():
    """score_pairs on CPU store columns == the plain version on the
    gathered rows, and launches no kernel."""
    a, b = _gen(np.random.default_rng(11), 128, 24, 2**30, 2**31, 0.3)
    q_cols = [torch.from_numpy(x) for x in a]
    c_cols = [torch.from_numpy(x) for x in b]
    rng = np.random.default_rng(2)
    qi = torch.from_numpy(rng.integers(0, 24, 40).astype(np.int32))
    ci = torch.from_numpy(rng.integers(0, 24, 40).astype(np.int32))
    n0 = score_pairs.launches
    got = score_pairs(q_cols, c_cols, qi, ci, 0.2).numpy()
    ql, cl = qi.long(), ci.long()
    want = score_pairs_ref(*[c[ql] for c in q_cols],
                           *[c[cl] for c in c_cols], 0.2).numpy()
    np.testing.assert_array_equal(got, want)
    assert score_pairs.launches == n0
