"""mhap_tpu_torch ops on the CPU against mhap_tpu's ops and oracle.

Same numpy inputs (from seeded generators) go through the JAX function
(Pallas kernels in interpret mode, as tests/test_minhash_pallas.py runs
them) and the port's counterpart.  Every output is an integer, so every
comparison is exact (bit-equal).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mhap_tpu.ops import bottomk as jbk
from mhap_tpu.ops import minhash as jmh
from mhap_tpu.ops import murmur3 as jm
from mhap_tpu.ops.minhash_pallas import (min_reduce_w1_pallas,
                                         weighted_min_reduce_pallas)
from mhap_tpu.oracle import murmur3 as om3
from mhap_tpu.oracle import sketch as osk
from mhap_tpu_torch.ops import bottomk as tbk
from mhap_tpu_torch.ops import minhash as tmh
from mhap_tpu_torch.ops import murmur3 as tm
from mhap_tpu_torch.ops.minhash_kernels import (min_reduce_w1,
                                                weighted_min_reduce)


def _u64(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | \
        np.asarray(lo).astype(np.uint64)


def _seq_with_n(seed, B=3, L=120):
    """ACGT rows with N (and one lower-case-derived IUPAC code) in them."""
    rng = np.random.default_rng(seed)
    seq = np.frombuffer(b"ACGTN", np.uint8)[rng.integers(0, 5, (B, L))]
    seq = seq.copy()
    seq[0, 10] = ord("R")
    return seq


@pytest.mark.parametrize("k", [16, 12, 15])
def test_murmur3_128_matches_jax_and_oracle(k):
    seq = _seq_with_n(k)
    got = tm.kmer_hashes_128(torch.from_numpy(seq), k).numpy().view(
        np.uint64)
    hi, lo = jm.kmer_hashes_128(jnp.asarray(seq), k)
    np.testing.assert_array_equal(got, _u64(hi, lo))
    for b in range(seq.shape[0]):
        win = np.lib.stride_tricks.sliding_window_view(seq[b], k)
        np.testing.assert_array_equal(got[b], om3.hash_kmers_128(win))


@pytest.mark.parametrize("k", [12, 16, 13])
def test_murmur3_32_matches_jax_and_oracle(k):
    seq = _seq_with_n(100 + k)
    got = tm.kmer_hashes_32(torch.from_numpy(seq), k).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jm.kmer_hashes_32(jnp.asarray(seq), k)))
    for b in range(seq.shape[0]):
        win = np.lib.stride_tricks.sliding_window_view(seq[b], k)
        np.testing.assert_array_equal(
            got[b], om3.hash_kmers_32(win).view(np.int32))


def _minhash_inputs(seed):
    """tests/test_minhash_pallas.py inputs: B=4, L=400, k=16, repeats."""
    rng = np.random.default_rng(seed)
    B, L, k = 4, 400, 16
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (B, L))]
    seq = seq.copy()
    seq[:, 100:150] = seq[:, 50:100]
    lens = np.array([L, L, 213, k], np.int32)
    valid = np.arange(L - k + 1)[None, :] < (lens[:, None] - k + 1)
    hi, lo = jm.kmer_hashes_128(jnp.asarray(seq), k, 0)
    h = tm.kmer_hashes_128(torch.from_numpy(seq), k)
    return hi, lo, h, valid


def test_sort_and_count_matches_jax():
    hi, lo, h, valid = _minhash_inputs(41)
    g = jmh.sort_and_count(hi, lo, jnp.asarray(valid))
    t = tmh.sort_and_count(h, torch.from_numpy(valid))
    np.testing.assert_array_equal(t["h"].numpy().view(np.uint64),
                                  _u64(g["hi"], g["lo"]))
    first = np.asarray(g["first"])
    np.testing.assert_array_equal(t["first"].numpy(), first)
    np.testing.assert_array_equal(t["count"].numpy()[first],
                                  np.asarray(g["count"])[first])
    np.testing.assert_array_equal(t["tiebreak"].numpy(),
                                  np.asarray(g["tiebreak"]))
    assert np.asarray(g["count"])[first].max() >= 2  # repeats present


def test_dup_rows_matches_jax():
    hi, lo, h, valid = _minhash_inputs(43)
    valid[1, 50:] = False  # row 1 loses its repeat: not flagged
    got = tmh.dup_rows(h, torch.from_numpy(valid)).numpy()
    want = np.asarray(jmh.dup_rows(hi, lo, jnp.asarray(valid)))
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


@pytest.mark.parametrize("S", [64, 512])
def test_bottom_sketch_matches_jax(S):
    seq = _seq_with_n(7, B=4, L=300)
    lens = np.array([300, 250, 40, 12], np.int32)
    valid = np.arange(289)[None, :] < (lens[:, None] - 11)
    h32 = tm.kmer_hashes_32(torch.from_numpy(seq), 12)
    got = tbk.bottom_sketch(h32, torch.from_numpy(valid), S)
    want = jbk.bottom_sketch(jnp.asarray(h32.numpy()), jnp.asarray(valid),
                             sketch_size=S)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_min_reduce_w1_ref_matches_pallas():
    hi, lo, h, valid = _minhash_inputs(43)
    want = np.asarray(min_reduce_w1_pallas(
        hi, lo, jnp.asarray(valid), num_hashes=32, interpret=True))
    got = tmh.min_reduce_w1_ref(h, torch.from_numpy(valid), 32).numpy()
    np.testing.assert_array_equal(got, want)


def test_weighted_min_reduce_ref_matches_pallas():
    hi, lo, h, valid = _minhash_inputs(41)
    g = jmh.sort_and_count(hi, lo, jnp.asarray(valid))
    w = jnp.where(g["first"], jnp.minimum(g["count"], 4), 0)
    act = g["first"] & (w > 0)
    want = np.asarray(weighted_min_reduce_pallas(
        g["hi"], g["lo"], w, act, g["tiebreak"], num_hashes=32, w_max=4,
        interpret=True))
    t = tmh.sort_and_count(h, torch.from_numpy(valid))
    got = tmh.weighted_min_reduce_ref(
        t["h"], torch.from_numpy(np.array(w)), torch.from_numpy(np.array(act)),
        t["tiebreak"], 32).numpy()
    np.testing.assert_array_equal(got, want)


def test_weighted_min_reduce_ref_weight_100():
    """A row with one k-mer at weight 100 against the JAX scan
    formulation (ops/minhash.weighted_min_reduce), plus rows at 1..3."""
    rng = np.random.default_rng(5)
    B, n, H = 3, 40, 16
    h = rng.integers(-2**63, 2**63 - 1, (B, n), dtype=np.int64)
    w = rng.integers(1, 4, (B, n)).astype(np.int32)
    w[0, 7] = 100
    act = rng.random((B, n)) < 0.9
    act[0, 7] = True
    tb = np.tile(np.arange(n, dtype=np.int32), (B, 1))
    hu = h.view(np.uint64)
    want = np.asarray(jmh.weighted_min_reduce(
        jnp.asarray((hu >> np.uint64(32)).astype(np.uint32)),
        jnp.asarray((hu & np.uint64(0xFFFFFFFF)).astype(np.uint32)),
        jnp.asarray(w), jnp.asarray(act), jnp.asarray(tb), num_hashes=H,
        w_max=128))
    got = tmh.weighted_min_reduce_ref(
        torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(act),
        torch.from_numpy(tb), H).numpy()
    np.testing.assert_array_equal(got, want)


def test_weighted_rows_match_oracle_sketch():
    """sort_and_count + the weighted kernel's plain version at exact
    counts gives the oracle's tf-weighted sketch of repeat reads."""
    rng = np.random.default_rng(9)
    arr = np.array(list("ACGT"))
    reads = ["".join(arr[rng.integers(0, 4, 150)])
             + "".join(arr[rng.integers(0, 4, 25)]) * 7
             + "".join(arr[rng.integers(0, 4, 150)]),
             "".join(arr[rng.integers(0, 4, 300)])]
    L = max(map(len, reads))
    codes = np.zeros((2, L), np.uint8)
    for i, r in enumerate(reads):
        codes[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
    lens = np.array([len(r) for r in reads])
    h = tm.kmer_hashes_128(torch.from_numpy(codes), 16)
    valid = torch.from_numpy(np.arange(L - 15)[None, :] < (lens[:, None] - 15))
    assert tmh.dup_rows(h, valid).numpy().tolist() == [True, False]
    got = tmh.minhash_weighted_rows(h, valid, 64,
                                    weighted_min_reduce).numpy()
    for i, r in enumerate(reads):
        np.testing.assert_array_equal(
            got[i], osk.minhash_sketch(r, 16, 64, None, 0.9))


def test_wrappers_take_plain_version_on_cpu():
    hi, lo, h, valid = _minhash_inputs(43)
    v = torch.from_numpy(valid)
    n1, n2 = min_reduce_w1.launches, weighted_min_reduce.launches
    np.testing.assert_array_equal(min_reduce_w1(h, v, 32).numpy(),
                                  tmh.min_reduce_w1_ref(h, v, 32).numpy())
    ones = torch.ones_like(h, dtype=torch.int32)
    tb = torch.arange(h.shape[1], dtype=torch.int32).expand_as(h)
    np.testing.assert_array_equal(
        weighted_min_reduce(h, ones, v, tb, 32).numpy(),
        tmh.min_reduce_w1_ref(h, v, 32).numpy())
    assert (min_reduce_w1.launches, weighted_min_reduce.launches) == (n1, n2)
