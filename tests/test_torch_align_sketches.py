"""The port's host aligner, windowed sub-sketches, LSH index, cosine
sketch and counters (mhap_tpu_torch/align, mhap_tpu_torch/sketches)
against the JAX package's on the same inputs: Gotoh and one-skip scores,
coordinates and operation lists, overlap scores,
MinHashBitSequenceSubSketches overlap info with ``to_bytes`` byte-equal,
BitVectorIndex neighbours with the same rng, CosineDistanceSketch bits,
CountMin tables and ClassicCounter counts.  All exact: the DP is float32
in the Java loop order in both."""

import numpy as np
import pytest

from mhap_tpu.align import aligner as jal
from mhap_tpu.align import elements as jel
from mhap_tpu.sketches import bitindex as jbi
from mhap_tpu.sketches import bits as jbits
from mhap_tpu.sketches import cosine as jcos
from mhap_tpu.sketches import counters as jcnt
from mhap_tpu_torch.align import aligner as tal
from mhap_tpu_torch.align import elements as tel
from mhap_tpu_torch.sketches import bitindex as tbi
from mhap_tpu_torch.sketches import bits as tbits
from mhap_tpu_torch.sketches import cosine as tcos
from mhap_tpu_torch.sketches import counters as tcnt


def random_dna(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def mutate(rng, s, err=0.1):
    arr = np.array(list("ACGT"))
    out = []
    for ch in s:
        r = rng.random()
        if r < err / 3:
            out += [ch, str(arr[rng.integers(0, 4)])]
        elif r < 2 * err / 3:
            pass
        elif r < err:
            out.append(str(arr[rng.integers(0, 4)]))
        else:
            out.append(ch)
    return "".join(out)


def same_alignment(got, want):
    assert (got.a1, got.a2, got.b1, got.b2, got.score) == \
        (want.a1, want.a2, want.b1, want.b2, want.score)
    if want.operations is None:
        assert got.operations is None
    else:
        assert [o.name for o in got.operations] == \
            [o.name for o in want.operations]


def string_pairs():
    rng = np.random.default_rng(11)
    g = random_dna(rng, 300)
    return [("ACGTACGTAC", "ACGTACGTAC"), ("AAACGTTTT", "AAATTTT"),
            ("GGGGGACGTACGGGGG", "TTTACGTACGTTT"),
            ("XXXXABCDE", "ABCDEYYYY"), ("A", "C"),
            (g[:120], mutate(rng, g[:120])), (g[50:160], mutate(rng, g[:200])),
            (random_dna(rng, 90), random_dna(rng, 70)), ("AAAA" * 20, "A" * 33)]


@pytest.mark.parametrize("store_path", [True, False])
@pytest.mark.parametrize("params", [(-1.0, -0.5, 0.0), (-2.0, -0.5, 0.0),
                                    (-3.0, -1.0, 0.0), (-0.52, 0.0, -0.48)])
def test_aligners_equal_to_jax(store_path, params):
    for a, b in string_pairs():
        pa, pb = tal.AlignElementString(a), tal.AlignElementString(b)
        ja, jb = jal.AlignElementString(a), jal.AlignElementString(b)
        t, j = tal.Aligner(store_path, *params), jal.Aligner(store_path,
                                                            *params)
        got = t.local_align_smith_water_gotoh(pa, pb)
        want = j.local_align_smith_water_gotoh(ja, jb)
        same_alignment(got, want)
        if store_path:
            for m in (1, 3, 50):
                assert got.get_overlap_score(m) == want.get_overlap_score(m)
        same_alignment(t.local_align_one_skip(pa, pb),
                       j.local_align_one_skip(ja, jb))


def test_generic_elements_equal_to_jax():
    """AlignElementSketch: the element-by-element similarity path."""
    rng = np.random.default_rng(4)
    words = rng.integers(0, 2**63, (7, 2), dtype=np.uint64)
    ps = [tbits.BitSketch(w) for w in words]
    js = [jbits.BitSketch(w) for w in words]
    t = tal.Aligner(True, -0.3, -0.1, -0.5)
    j = jal.Aligner(True, -0.3, -0.1, -0.5)
    pa = tel.AlignElementSketch(ps[:4], 100, 400)
    pb = tel.AlignElementSketch(ps[2:], 100, 500)
    ja = jel.AlignElementSketch(js[:4], 100, 400)
    jb = jel.AlignElementSketch(js[2:], 100, 500)
    same_alignment(t.local_align_smith_water_gotoh(pa, pb),
                   j.local_align_smith_water_gotoh(ja, jb))
    same_alignment(t.local_align_one_skip(pa, pb),
                   j.local_align_one_skip(ja, jb))


@pytest.fixture(scope="module")
def subsketches():
    rng = np.random.default_rng(9)
    genome = random_dna(rng, 2400)
    a, b = genome[:1600], mutate(rng, genome[800:2400], 0.03)
    step, words = 200, 2
    return [(mod.MinHashBitSequenceSubSketches(a, 12, step, words),
             mod.MinHashBitSequenceSubSketches(b, 12, step, words))
            for mod in (tel, jel)]


def test_subsketches_equal_to_jax(subsketches):
    (pa, pb), (ja, jb) = subsketches
    assert pa.to_bytes() == ja.to_bytes() and pb.to_bytes() == jb.to_bytes()
    for params in ((-0.52, 0.0, -0.48), (-0.3, 0.0, -0.6)):
        got = pa.get_overlap_info(tal.Aligner(True, *params), pb)
        want = ja.get_overlap_info(jal.Aligner(True, *params), jb)
        assert got == want
        assert got[0] > 0
        assert pa.get_overlap_info(tal.Aligner(False, *params), pb) == \
            ja.get_overlap_info(jal.Aligner(False, *params), jb)
    back = tel.MinHashBitSequenceSubSketches.from_bytes(pa.to_bytes())
    jback = jel.MinHashBitSequenceSubSketches.from_bytes(ja.to_bytes())
    assert back.to_bytes() == jback.to_bytes() == pa.to_bytes()
    el = back.alignment_sketch
    assert (el.step_size, el.seq_length) == (200, 1600)
    rng = np.random.default_rng(1)
    s = random_dna(rng, 700)
    got = tel.MinHashBitSequenceSubSketches.compute_sequences(s, 12, 300, 1)
    want = jel.MinHashBitSequenceSubSketches.compute_sequences(s, 12, 300, 1)
    assert len(got) == len(want) == 3
    assert all(np.array_equal(g.bits, w.bits) for g, w in zip(got, want))


def test_bit_vector_index_equal_to_jax():
    rng = np.random.default_rng(7)
    base = random_dna(rng, 700)
    seqs = [("near", mutate(rng, base, 0.03))] + [
        (f"far{i}", random_dna(rng, 700)) for i in range(6)]
    pairs_t = [(k, tbits.MinHashBitSketch(s, 12, 2)) for k, s in seqs]
    pairs_j = [(k, jbits.MinHashBitSketch(s, 12, 2)) for k, s in seqs]
    ti = tbi.BitVectorIndex(pairs_t, 0.7, 0.95, rng=np.random.default_rng(3))
    ji = jbi.BitVectorIndex(pairs_j, 0.7, 0.95, rng=np.random.default_rng(3))
    assert np.array_equal(ti.bits_used, ji.bits_used)
    assert ti.tables == ji.tables
    for q in (base, seqs[3][1]):
        got = ti.get_neighbors(tbits.MinHashBitSketch(q, 12, 2))
        want = ji.get_neighbors(jbits.MinHashBitSketch(q, 12, 2))
        assert got == want
    assert "near" in got or "far2" in got
    assert tbi.BitVectorIndex(pairs_t, 0.7, 0.95).bits_used.tolist() == \
        jbi.BitVectorIndex(pairs_j, 0.7, 0.95).bits_used.tolist()


def test_cosine_sketch_equal_to_jax():
    rng = np.random.default_rng(8)
    for n, words, seed in ((16, 1, 1), (40, 2, 77)):
        v = rng.standard_normal(n)
        assert np.array_equal(tcos.CosineDistanceSketch(v, words, seed).bits,
                              jcos.CosineDistanceSketch(v, words, seed).bits)
    assert np.array_equal(tcos.random_gaussian_vector(10, 5),
                          jcos.random_gaussian_vector(10, 5))


def test_counters_equal_to_jax():
    for obj in ("ACGT", "", 12345, -7, b"\x00\x01xyz"):
        for seed in (0, 42):
            assert np.array_equal(tcnt.compute_hashes_int(obj, 4, seed),
                                  jcnt.compute_hashes_int(obj, 4, seed))
    with pytest.raises(TypeError):
        tcnt.compute_hashes_int(1.5, 2, 0)
    pairs = [(tcnt.CountMin(depth=4, width=97, seed=3),
              jcnt.CountMin(depth=4, width=97, seed=3)),
             (tcnt.CountMin(eps=0.05, confidence=0.99, seed=1),
              jcnt.CountMin(eps=0.05, confidence=0.99, seed=1))]
    for t, j in pairs:
        for i in range(300):
            obj = f"item{i % 37}" if i % 3 else i % 11
            t.add(obj, 1 + i % 4)
            j.add(obj, 1 + i % 4)
        assert np.array_equal(t.table, j.table)
        assert t.total_added == j.total_added
        assert [t.get_count(f"item{i}") for i in range(40)] == \
            [j.get_count(f"item{i}") for i in range(40)]
        with pytest.raises(ValueError):
            t.add("x", 0)
    tc, jc = tcnt.ClassicCounter(), jcnt.ClassicCounter()
    for obj, inc in (("x", 1), ("y", 3), ("x", 4), (5, 2)):
        tc.add(obj, inc)
        jc.add(obj, inc)
    assert dict(tc.counts) == dict(jc.counts)
    assert (tc.max_count, tc.total, tc.get_count("z")) == \
        (jc.max_count, jc.total, jc.get_count("z"))
