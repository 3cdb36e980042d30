"""The port's Guava bloom filter and --supress-noise 1/2 weights on the
CPU against the JAX package: murmur3_128 of longs and the bloom's words
and probes against ``oracle.filter.GuavaBloomFilter``, file membership
(keepKmer) and the tf-idf and legacy weights of both modes pointwise
against ``VectorFrequencyFilter``, with the exact set and the bloom.
Same numpy-seeded inputs on both sides; every compared value is an
integer or a float64's bits: exact."""

import numpy as np
import pytest
import torch

from mhap_tpu.oracle import murmur3 as om3
from mhap_tpu.oracle import sketch as osk
from mhap_tpu.oracle.filter import GuavaBloomFilter as JaxBloom
from mhap_tpu.pipeline.freqfilter import VectorFrequencyFilter as JaxVFF
from mhap_tpu_torch.io.filter import GuavaBloomFilter
from mhap_tpu_torch.ops.murmur3 import murmur3_128_long
from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter

from test_torch_supress_noise import inputs, jax_fc, port_fc  # noqa: F401

torch.set_num_threads(1)


def test_murmur3_of_longs():
    x = np.random.default_rng(3).integers(-2**63, 2**63 - 1, 4000,
                                           dtype=np.int64)
    x[:4] = [0, -1, 2**63 - 1, -2**63]
    h1, h2 = om3.murmur3_x64_128(x.astype("<u8").view(np.uint8)
                                 .reshape(-1, 8), 0)
    g1, g2 = murmur3_128_long(torch.from_numpy(x))
    np.testing.assert_array_equal(g1.numpy().view(np.uint64), h1)
    np.testing.assert_array_equal(g2.numpy().view(np.uint64), h2)


@pytest.mark.parametrize("n", [1, 37, 5000])
def test_bloom_words_and_probes(n):
    """A filter sized like a file header of n: its size, hash count and
    words bit-equal to the oracle's after the same insertions, and
    mightContain equal on the inserted keys and on random ones."""
    rng = np.random.default_rng(n)
    keys = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
    want = JaxBloom(n)
    for k in keys.view(np.uint64).tolist():
        want.add(k)
    got = GuavaBloomFilter(n)
    got.add(torch.from_numpy(keys))
    assert (got.bit_size, got.num_hashes) == (want.bit_size,
                                              want.num_hashes)
    np.testing.assert_array_equal(got.words.numpy().view(np.uint64),
                                  want.words)
    probe = np.concatenate([keys, rng.integers(-2**63, 2**63 - 1, 20_000,
                                               dtype=np.int64)])
    np.testing.assert_array_equal(
        got.contains(torch.from_numpy(probe)).numpy(),
        want.contains_vec(probe.view(np.uint64)))
    assert got.contains(torch.from_numpy(keys)).all()


@pytest.mark.parametrize("ru", [1, 2])
@pytest.mark.parametrize("bloom", [False, True])
def test_modes_pointwise(inputs, ru, bloom):
    """keepKmer and the tf-idf and legacy weights of every k-mer of the
    reads and of the file, at counts 1..10,000."""
    reads, lines = inputs
    keys = np.unique(np.concatenate(
        [osk.sequence_kmer_hashes_128(r, 16).astype(np.uint64)
         for r in reads[:3]]
        + [JaxVFF(jax_fc(lines, 0.9, 0, False)).frac_keys]))
    counts = np.random.default_rng(7).integers(1, 10_001, len(keys))
    tk, tc = torch.from_numpy(keys.view(np.int64)), torch.from_numpy(counts)
    for rw in (0.9, -1.0):
        want = JaxVFF(jax_fc(lines, rw, ru, bloom))
        vf = VectorFrequencyFilter(port_fc(lines, rw, ru, bloom), "cpu")
        keep = vf.member(tk)
        if ru == 1:  # keepKmer
            np.testing.assert_array_equal(keep.numpy(),
                                          want.keep_mask(keys))
        assert 0 < int(keep.sum()) < len(keys)
        np.testing.assert_array_equal(vf.weights(tk, tc, rw).numpy(),
                                      want.weights(keys, counts, rw))
    if ru == 2:  # non-members weigh 1.0 * count, members range * count
        w = vf.weights(tk, tc, 0.9).numpy()
        out = ~want.fc.valid_mers.contains_vec(keys) if bloom else np.array(
            [int(k) not in want.fc.valid_mers for k in keys])
        np.testing.assert_array_equal(w[out], counts[out])
