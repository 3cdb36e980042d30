"""The port's numpy reference (mhap_tpu_torch/oracle) against the JAX
package's (mhap_tpu/oracle) on the same numpy inputs, and against the
port's own device path.

  * murmur3 over byte rows and k-mer rows, both variants and seeds;
  * the stage-1 MinHash (every weight mode, with and without a filter,
    canonical k-mers) and the stage-2 bottom sketch;
  * get_overlap_info on identical, unrelated and overlapping pairs;
  * every FrequencyCounts method on a small filter file at
    --supress-noise 0, 1 and 2, with the exact set and the Guava bloom;
  * overlap_self and overlap_query line lists on at most 64 reads, with
    and without a filter;
  * the oracle's line set equal to TorchOverlapper(cfg, device="cpu")'s
    on the same reads, unfiltered and filtered: the property the oracle
    exists for.
Everything is compared exactly."""

import numpy as np
import pytest
import torch

from mhap_tpu.oracle import filter as jfilter
from mhap_tpu.oracle import murmur3 as jm3
from mhap_tpu.oracle import pipeline as jpipe
from mhap_tpu.oracle import scorer as jscorer
from mhap_tpu.oracle import seq as jseq
from mhap_tpu.oracle import sketch as jsketch
from mhap_tpu_torch.io.filter import FrequencyCounts as DeviceCounts
from mhap_tpu_torch.oracle import filter as tfilter
from mhap_tpu_torch.oracle import murmur3 as tm3
from mhap_tpu_torch.oracle import pipeline as tpipe
from mhap_tpu_torch.oracle import scorer as tscorer
from mhap_tpu_torch.oracle import seq as tseq
from mhap_tpu_torch.oracle import sketch as tsketch
from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

torch.set_num_threads(1)

CFG = dict(num_hashes=128, ordered_sketch_size=512, num_min_matches=2)


@pytest.fixture(scope="module")
def reads(synthetic_reads):
    """16 of the conftest reads (3 kb, 10% error, a 20 kb genome), one
    with N bases, one with a tandem repeat, one too short to keep."""
    _genome, rs, _pos = synthetic_reads
    rs = list(rs[:16])
    rs[3] = rs[3][:1000] + "NNNNN" + rs[3][1000:]
    rs[5] = rs[5][:1500] + "ACGTTGCA" * 4 + rs[5][1500:]
    rs.append("ACGT" * 10)
    return rs


def filter_lines(reads, n=60):
    """A filter file of k-mers from the reads: fractions on both sides
    of the 1e-5 cutoff, one k-mer listed twice."""
    rng = np.random.default_rng(17)
    lines = [f"{4 * n} {n}"]
    for i in range(n):
        r = reads[i % 6]
        p = int(rng.integers(0, len(r) - 16))
        frac = float(rng.choice([2e-6, 3e-5, 1e-4, 5e-4, 2e-3]))
        lines.append(f"{r[p:p + 16].upper()} {frac} 7")
    lines.append(lines[1].split()[0] + " 0.004")
    return lines


def test_murmur3_equal_to_jax():
    rng = np.random.default_rng(1)
    for nbytes in (0, 1, 3, 4, 7, 8, 15, 16, 17, 24, 31, 32, 40):
        data = rng.integers(0, 256, (9, nbytes), dtype=np.uint8)
        for seed in (0, 1, 0xDEADBEEF, -5):
            assert all(np.array_equal(x, y) for x, y in zip(
                tm3.murmur3_x64_128(data, seed),
                jm3.murmur3_x64_128(data, seed)))
            assert np.array_equal(tm3.murmur3_x86_32(data, seed),
                                  jm3.murmur3_x86_32(data, seed))
    codes = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (50, 16))]
    assert np.array_equal(tm3.utf16le_bytes(codes), jm3.utf16le_bytes(codes))
    assert np.array_equal(tm3.hash_kmers_128(codes, 3),
                          jm3.hash_kmers_128(codes, 3))
    assert np.array_equal(tm3.hash_kmers_32(codes), jm3.hash_kmers_32(codes))


def test_seq_equal_to_jax():
    s = "ACGTNacgtRYKMBVDHSW-x"
    assert tseq.reverse_complement(s) == jseq.reverse_complement(s)
    assert tseq.rc_bytes(s.encode()) == jseq.rc_bytes(s.encode())


def test_sketches_equal_to_jax(reads):
    fc_lines = filter_lines(reads)
    tf = tfilter.FrequencyCounts(fc_lines, 1e-5, 0.9, 0, False, 3.0, True)
    jf = jfilter.FrequencyCounts(fc_lines, 1e-5, 0.9, 0, False, 3.0, True)
    for r in (reads[0], reads[3], reads[5]):
        for rw, filt in ((-1.0, None), (-1.0, "f"), (0.9, "f"), (1.5, "f"),
                         (0.9, None)):
            got = tsketch.minhash_sketch(r, 16, 64, tf if filt else None, rw)
            want = jsketch.minhash_sketch(r, 16, 64, jf if filt else None, rw)
            assert np.array_equal(got, want), (rw, filt)
        for fn in (tsketch.bottom_sketch,):
            got, n = fn(r, 12, 300)
            want, m = getattr(jsketch, fn.__name__)(r, 12, 300)
            assert n == m and np.array_equal(got, want)
    r = reads[1][:400]
    assert np.array_equal(tsketch.minhash_sketch(r, 12, 32, canonical=True),
                          jsketch.minhash_sketch(r, 12, 32, canonical=True))
    assert np.array_equal(tsketch.bottom_sketch_values(r, 12, 100),
                          jsketch.bottom_sketch_values(r, 12, 100))
    assert np.array_equal(tsketch.bottom_sketch_values(r, 12, 100, False),
                          jsketch.bottom_sketch_values(r, 12, 100, False))
    h1 = tsketch.bottom_sketch_values(r, 12, 100)
    h2 = tsketch.bottom_sketch_values(reads[1][200:600], 12, 100)
    assert tsketch.bottom_values_jaccard(h1, h2) == \
        jsketch.bottom_values_jaccard(h1, h2)
    with pytest.raises(tsketch.ZeroNGramsFound):
        tsketch.minhash_sketch("ACGT", 16, 8)


def test_overlap_info_equal_to_jax(reads):
    def sk(s, mod):
        return mod.bottom_sketch(s, 12, 512)

    a, b = reads[0], reads[1]
    pairs = [(a, a), (a, "".join(np.random.default_rng(2).choice(
        list("ACGT"), 3000))), (a, b), (a, jseq.reverse_complement(b))]
    pairs += [(reads[i], reads[j]) for i in range(4) for j in range(4, 8)]
    hits = 0
    for x, y in pairs:
        (s1, n1), (s2, n2) = sk(x, tsketch), sk(y, tsketch)
        got = tscorer.get_overlap_info(s1, n1, s2, n2, 12, 0.2)
        want = jscorer.get_overlap_info(s1, n1, s2, n2, 12, 0.2)
        assert got == want
        hits += got[0] > 0
    assert 2 <= hits < len(pairs)
    assert tscorer.jaccard_to_identity(0.3, 12) == \
        jscorer.jaccard_to_identity(0.3, 12)


@pytest.mark.parametrize("remove_unique", [0, 1, 2])
@pytest.mark.parametrize("use_bloom", [False, True])
def test_frequency_counts_equal_to_jax(reads, remove_unique, use_bloom):
    lines = filter_lines(reads)
    args = (lines, 1e-5, 0.9, remove_unique, False, 3.0, True)
    got = tfilter.FrequencyCounts(*args, use_bloom=use_bloom)
    want = jfilter.FrequencyCounts(*args, use_bloom=use_bloom)
    assert got.fraction_counts == want.fraction_counts
    assert (got.max_value, got.min_value, got.min_idf(), got.max_idf()) == \
        (want.max_value, want.min_value, want.min_idf(), want.max_idf())
    assert got.kmer_sizes == want.kmer_sizes
    if remove_unique == 0:
        assert got.valid_mers is None and want.valid_mers is None
    elif use_bloom:
        assert np.array_equal(got.valid_mers.words, want.valid_mers.words)
        assert got.valid_mers.num_hashes == want.valid_mers.num_hashes
    else:
        assert got.valid_mers == want.valid_mers
    rng = np.random.default_rng(9)
    keys = [tfilter.kmer_string_hash(l.split()[0], True) for l in lines[1:]]
    keys += [int(k) for k in rng.integers(0, 2**63, 40, dtype=np.uint64)]
    for h in keys:
        assert got.document_frequency_ratio(h) == \
            want.document_frequency_ratio(h)
        assert got.is_popular(h) == want.is_popular(h)
        assert got.keep_kmer(h) == want.keep_kmer(h)
        assert got.scaled_idf(h) == want.scaled_idf(h)
        assert got.scaled_idf(h, 10.0) == want.scaled_idf(h, 10.0)
    assert got.tf_weight(3) == want.tf_weight(3)
    assert tfilter.FrequencyCounts(*args[:4], True, *args[5:]).tf_weight(
        3) == 1.0
    for kmer in ("ACGTACGTACGTACGA", "TTTTGGGGCCCCAAAA"):
        for rc in (False, True):
            assert tfilter.kmer_string_hash(kmer, rc) == \
                jfilter.kmer_string_hash(kmer, rc)


def test_frequency_counts_refusals():
    for ru, off in ((3, 0.5), (0, 1.0)):
        with pytest.raises(ValueError):
            tfilter.FrequencyCounts(["1 1"], 1e-5, off, ru, False, 3.0, True)


@pytest.fixture(scope="module")
def oracle_runs(reads):
    """The port's oracle on the reads: self, with a filter, and a query
    run of the last 6 reads against a box of the first 10."""
    fc = tfilter.FrequencyCounts(filter_lines(reads), 1e-5, 0.9, 0, False,
                                 3.0, True)
    return dict(
        self=tpipe.overlap_self(reads, CFG),
        filtered=tpipe.overlap_self(reads, CFG, fc),
        query=tpipe.overlap_query(reads[:10], reads[10:], CFG),
        no_self=tpipe.overlap_query(reads[:10], reads[10:], CFG,
                                    no_self=True))


def test_overlap_lines_equal_to_jax(reads, oracle_runs):
    fc = jfilter.FrequencyCounts(filter_lines(reads), 1e-5, 0.9, 0, False,
                                 3.0, True)
    assert oracle_runs["self"] == jpipe.overlap_self(reads, CFG)
    assert oracle_runs["filtered"] == jpipe.overlap_self(reads, CFG, fc)
    assert oracle_runs["query"] == jpipe.overlap_query(reads[:10],
                                                       reads[10:], CFG)
    assert oracle_runs["no_self"] == jpipe.overlap_query(
        reads[:10], reads[10:], CFG, no_self=True)
    assert len(oracle_runs["self"]) >= 10
    assert oracle_runs["filtered"] != oracle_runs["self"]
    assert set(oracle_runs["no_self"]) < set(oracle_runs["query"])
    headers = [f"r{i}" for i in range(len(reads))]
    got = tpipe.overlap_self(reads[:6], CFG, headers=headers[:6])
    assert got == jpipe.overlap_self(reads[:6], CFG, headers=headers[:6])
    assert got and all(l.startswith("r") for l in got)


def test_oracle_equals_device_path(reads, oracle_runs):
    """The port's oracle and its device path (kernels' plain versions on
    the CPU) give the same line set, with and without a filter."""
    assert TorchOverlapper(CFG, device="cpu").overlap_self(reads) == \
        oracle_runs["self"]
    fc = DeviceCounts(iter(filter_lines(reads)), 1e-5, 0.9, 0, False, 3.0,
                      True)
    ov = TorchOverlapper(CFG, device="cpu",
                         kmer_filter=VectorFrequencyFilter(fc, "cpu"))
    assert ov.overlap_self(reads) == oracle_runs["filtered"]
