"""Kernel 6's plain version (ops/bits.py) and the port's bit-sketch family
(sketches/bits.py) against the JAX package on the same numpy words and
reads, and the kernel's tiling rehearsed on the CPU.

  * on uint32 words the port's ``bit_similarity_matrix`` is bit-equal to
    the JAX one (jax.lax.population_count);
  * on uint64 words it is exact: the recovered count equals a numpy
    popcount, and the float32 arithmetic is 1 - count / 64W rounded at
    each step;
  * the JAX version casts uint64 words to uint32 under JAX's 32-bit
    default, so with the top bit set in every word it differs from
    ``BitSketch.similarity`` while the port does not (the trap);
  * a numpy model of csrc/bits.cu (64 x 64 output tiles of 16 x 16
    threads with 4 x 4 outputs each, 16-word chunks through shared
    memory, zero-filled rows past the edge, masked stores) equals the
    plain version at NA, NB of 1, 63, 64, 65, 130 and W of 1, 3, 8, 33;
  * BitSketch, MinHashBitSketch, SimHash, pack_last_bits_msb_first and
    the n-gram expansions are equal to JAX's.
Every comparison is exact."""

import numpy as np
import pytest
import torch

from chip_smoke import bits_adversarial
from mhap_tpu.sketches import bits as jbits
from mhap_tpu_torch.ops import bits as ops_bits
from mhap_tpu_torch.ops.bits_kernels import bit_similarity
from mhap_tpu_torch.sketches import bits as tbits

torch.set_num_threads(1)
POPCOUNT8 = np.array([bin(i).count("1") for i in range(256)], np.int64)


def popcount_rows(a, b):
    """numpy popcount(a[i] ^ b[j]) summed over words, int64 [NA, NB]."""
    x = a[:, None, :] ^ b[None, :, :]
    return POPCOUNT8[x.view(np.uint8)].reshape(len(a), len(b), -1).sum(-1)


def port_sim(a, b):
    return tbits.bit_similarity_matrix(a, b, device="cpu").numpy()


def random_words(rng, n, w, dt):
    return rng.integers(0, np.iinfo(dt).max, (n, w), dtype=dt,
                        endpoint=True)


def test_adversarial_set_equals_jax_on_uint32_and_numpy_on_uint64():
    """The chip's adversarial set (chip_smoke.bits_adversarial): bit-equal
    to JAX on uint32 words, to 1 - popcount / 64W on uint64 words."""
    cases = bits_adversarial()
    assert len(cases) == 96
    for a, b in cases:
        got = port_sim(a, b)
        assert got.dtype == np.float32 and got.shape == (len(a), len(b))
        if a.dtype == np.uint32:
            want = np.asarray(jbits.bit_similarity_matrix(a, b))
        else:
            nbits = np.float32(64 * a.shape[1])
            want = np.float32(1) - (popcount_rows(a, b).astype(np.float32)
                                    / nbits)
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("w", [1, 8, 16, 33])
def test_uint32_bit_equal_to_jax(w):
    rng = np.random.default_rng(w)
    a = random_words(rng, 37, w, np.uint32)
    b = random_words(rng, 29, w, np.uint32)
    got = port_sim(a, b)
    want = np.asarray(jbits.bit_similarity_matrix(a, b))
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert (np.diag(port_sim(a, a)) == 1.0).all()


@pytest.mark.parametrize("w", [1, 4, 8, 33])
def test_uint64_counts_exact(w):
    """round((1 - out) * 64W) is the numpy popcount, and equals
    BitSketch's intersection count; the uint32 view of the same words
    gives the same similarity."""
    rng = np.random.default_rng(100 + w)
    a = random_words(rng, 21, w, np.uint64)
    b = random_words(rng, 18, w, np.uint64)
    got = port_sim(a, b)
    counts = np.rint((1.0 - got.astype(np.float64)) * 64 * w).astype(int)
    assert np.array_equal(counts, popcount_rows(a, b))
    for i, j in ((0, 0), (3, 7), (20, 17)):
        sa, sb = tbits.BitSketch(a[i]), tbits.BitSketch(b[j])
        assert 64 * w - counts[i, j] == sa.get_intersection_count(sb)
        assert got[i, j] == np.float32(sa.similarity(sb))
    half = port_sim(a.view(np.uint32), b.view(np.uint32))
    assert np.array_equal(half, got)


def test_uint64_trap_in_jax_version():
    """With the top bit set in each of four uint64 words a row, JAX's
    version differs from BitSketch.similarity; the port's equals it."""
    rng = np.random.default_rng(2024)
    a = random_words(rng, 2, 4, np.uint64) | np.uint64(1 << 63)
    jax_sim = np.asarray(jbits.bit_similarity_matrix(a, a[::-1].copy()))
    port = port_sim(a, a[::-1].copy())
    exact = jbits.BitSketch(a[0]).similarity(jbits.BitSketch(a[1]))
    assert jax_sim[0, 0] != np.float32(exact)
    assert port[0, 0] == np.float32(exact)
    assert port[0, 0] == np.float32(
        tbits.BitSketch(a[0]).similarity(tbits.BitSketch(a[1])))


def test_inputs_checked_and_empty_sides():
    a = np.zeros((3, 2), np.uint64)
    for bad in (np.zeros((3, 2), np.int32), np.zeros((3, 2), np.float32),
                [[1, 2]]):
        with pytest.raises(TypeError):
            tbits.bit_similarity_matrix(bad, bad, device="cpu")
    with pytest.raises(ValueError):
        tbits.bit_similarity_matrix(np.zeros((3, 0), np.uint32),
                                    np.zeros((3, 0), np.uint32),
                                    device="cpu")
    with pytest.raises(TypeError):  # one word width for both
        tbits.bit_similarity_matrix(a, np.zeros((3, 4), np.uint32),
                                    device="cpu")
    with pytest.raises(ValueError):
        tbits.bit_similarity_matrix(a, np.zeros((3, 3), np.uint64),
                                    device="cpu")
    assert port_sim(np.zeros((0, 2), np.uint64), a).shape == (0, 3)
    assert port_sim(a, np.zeros((0, 2), np.uint64)).shape == (3, 0)
    t = torch.from_numpy(a)  # tensors of torch.uint64 are taken too
    assert (tbits.bit_similarity_matrix(t, t, device="cpu") == 1).all()


def test_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py phase 13 runs it")
    a = np.zeros((2, 2), np.uint32)
    before = bit_similarity.launches
    with pytest.raises(RuntimeError):
        tbits.bit_similarity_matrix(a, a)  # device="cuda" by default
    with pytest.raises(RuntimeError):
        tbits.bit_similarity_matrix(a, a, device="cuda")
    assert bit_similarity.launches == before


# ---- kernel 6's tiling, rehearsed on the CPU ----

def kernel_model(a, b, tile=64, side=16, chunk=16):
    """numpy model of csrc/bits.cu: a grid of tile x tile output blocks;
    thread (tx, ty) owns rows ty + side r and columns tx + side c; word
    chunks staged transposed, zero-filled past NA, NB and the chunk's
    end; int32 counts; float32 1 - count / (bits W) stored only inside
    [NA, NB].  Unwritten outputs stay NaN."""
    bits = 8 * a.dtype.itemsize
    na, w = a.shape
    nb = b.shape[0]
    per = tile // side
    out = np.full((na, nb), np.nan, np.float32)
    nbits = np.float32(bits * w)
    for by in range((na + tile - 1) // tile):
        for bx in range((nb + tile - 1) // tile):
            row0, col0 = by * tile, bx * tile
            acc = np.zeros((side, side, per, per), np.int32)  # ty tx i j
            for k0 in range(0, w, chunk):
                kc = min(chunk, w - k0)
                sa = np.zeros((chunk, tile), a.dtype)  # [word][row]
                sb = np.zeros((chunk, tile), a.dtype)
                ra = a[row0:row0 + tile, k0:k0 + kc]
                rb = b[col0:col0 + tile, k0:k0 + kc]
                sa[:kc, :len(ra)] = ra.T
                sb[:kc, :len(rb)] = rb.T
                for k in range(kc):
                    ta = sa[k].reshape(per, side)  # [i, ty]
                    tb = sb[k].reshape(per, side)  # [j, tx]
                    x = ta.T[:, None, :, None] ^ tb.T[None, :, None, :]
                    acc += POPCOUNT8[x[..., None].view(np.uint8)].sum(
                        -1).astype(np.int32)
            for i in range(per):
                rows = row0 + np.arange(side) + side * i
                for j in range(per):
                    cols = col0 + np.arange(side) + side * j
                    keep = (rows[:, None] < na) & (cols[None, :] < nb)
                    val = np.float32(1) - acc[:, :, i, j].astype(
                        np.float32) / nbits
                    rr, cc = np.nonzero(keep)
                    out[rows[rr], cols[cc]] = val[rr, cc]
    return out


@pytest.mark.parametrize("dt", [np.uint32, np.uint64])
@pytest.mark.parametrize("w", [1, 3, 8, 33])
def test_kernel_model_equals_plain(dt, w):
    rng = np.random.default_rng(w)
    sizes = (1, 63, 64, 65, 130)
    for na in sizes:
        a = random_words(rng, na, w, dt)
        a[::4] |= dt(1) << dt(8 * np.dtype(dt).itemsize - 1)
        for nb in sizes:
            b = random_words(rng, nb, w, dt)
            got = kernel_model(a, b)
            want = port_sim(a, b)
            assert not np.isnan(got).any()
            assert np.array_equal(got.view(np.uint32),
                                  want.view(np.uint32)), (na, nb)


def test_plain_chunks_equal_one_pass(monkeypatch):
    """The plain version's row chunks (CHUNK_BYTES) do not change it."""
    rng = np.random.default_rng(5)
    a = random_words(rng, 50, 3, np.uint64)
    b = random_words(rng, 40, 3, np.uint64)
    whole = port_sim(a, b)
    monkeypatch.setattr(ops_bits, "CHUNK_BYTES", 7 * 40 * 24)
    assert np.array_equal(port_sim(a, b), whole)


# ---- the bit-sketch family ----

def random_dna(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


def test_pack_last_bits_equal_to_jax():
    rng = np.random.default_rng(7)
    for n in (0, 63, 64, 65, 512, 700):
        v = rng.integers(-2**31, 2**31, n).astype(np.int32)
        assert np.array_equal(tbits.pack_last_bits_msb_first(v),
                              jbits.pack_last_bits_msb_first(v))
    rows = rng.integers(-2**31, 2**31, (5, 512)).astype(np.int32)
    got = tbits.pack_last_bits_msb_first(rows)  # the port packs rows too
    assert got.shape == (5, 8) and got.dtype == np.uint64
    for r in range(5):
        assert np.array_equal(got[r], jbits.pack_last_bits_msb_first(
            rows[r]))


def test_ngram_expansions_equal_to_jax():
    rng = np.random.default_rng(5)
    s = random_dna(rng, 60)
    assert np.array_equal(tbits.compute_ngram_hashes(s, 12, 3),
                          jbits.compute_ngram_hashes(s, 12, 3))
    assert np.array_equal(tbits.compute_ngram_hashes(s, 12, 2, seed=9),
                          jbits.compute_ngram_hashes(s, 12, 2, seed=9))
    assert np.array_equal(tbits.compute_ngram_hashes_exact(s[:30], 10, 2),
                          jbits.compute_ngram_hashes_exact(s[:30], 10, 2))


def test_bit_sketches_equal_to_jax():
    rng = np.random.default_rng(3)
    s = random_dna(rng, 900)
    t = random_dna(rng, 900)
    for cls, args in ((tbits.MinHashBitSketch, (12, 4)),
                      (tbits.SimHash, (10, 2))):
        jcls = getattr(jbits, cls.__name__)
        ps, pt = cls(s, *args), cls(t, *args)
        js, jt = jcls(s, *args), jcls(t, *args)
        assert np.array_equal(ps.bits, js.bits)
        assert np.array_equal(pt.bits, jt.bits)
        assert ps.jaccard(pt) == js.jaccard(jt)
        assert ps.similarity(pt) == js.similarity(jt)
        assert ps.jaccard(ps) == 1.0
    vals = rng.integers(-2**31, 2**31, 256).astype(np.int32)
    assert np.array_equal(tbits.MinHashBitSketch(vals).bits,
                          jbits.MinHashBitSketch(vals).bits)
    words = rng.integers(0, 2**63, 3, dtype=np.uint64)
    p, j = tbits.BitSketch(words), jbits.BitSketch(words)
    assert [p.get_bit(i) for i in range(192)] == \
        [j.get_bit(i) for i in range(192)]
    q = tbits.BitSketch(words[::-1].copy())
    assert p.get_intersection_count(q) == j.get_intersection_count(
        jbits.BitSketch(words[::-1].copy()))
    with pytest.raises(ValueError):
        p.get_intersection_count(tbits.BitSketch(words[:2]))
