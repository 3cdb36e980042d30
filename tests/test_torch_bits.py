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
  * a numpy model of csrc/bits.cu (popc(a ^ b) = popc(a) + popc(b) -
    2 popc(a & b), the AND-popcount product by mma.sync m16n8k256 b1 from
    its fragment layout, 16-word chunks zero-padded past the row, quad
    popcounts, 32 x 64 warp tiles staged and stored by the persistent
    1-D walk) equals the plain version bit for bit, every output stored
    once, at NA, NB of 1, 63, 64, 65, 130, W of 1, 3, 8, 16, 17, 33, on
    uint32 and uint64 words; uint64 words and their uint32 view agree;
    the walk covers every tile once past the old grid's limit;
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


# ---- kernel 6's design, rehearsed on the CPU ----

# csrc/bits.cu: kWarps, kTM, kTN, kChunk, kTableMax, kPitch
WARPS, TM, TN, CHUNK, TABLE_MAX = 8, 32, 64, 16, 8192
PITCH = TN + 8
LANE = np.arange(32)
G, T = LANE >> 2, LANE & 3  # a lane's group and its place in the quad


def bmma_and_popc(acc, a_regs, b_regs):
    """One warp's mma.sync m16n8k256 b1 .and.popc by the PTX ISA's
    fragment layout: ``a_regs`` [32, 4] and ``b_regs`` [32, 2] uint32,
    ``acc`` [32, 4] updated.  A (16 x 256 bits): a0 of lane (g, t) is row
    g, bits 32t..32t+31; a1 row g + 8, the same bits; a2, a3 the same rows,
    bits 128 + 32t..; B (256 x 8): b0 is column g, bits 32t..; b1 bits
    128 + 32t..; D: c0, c1 row g, columns 2t, 2t + 1; c2, c3 row g + 8."""
    A = np.zeros((16, 8), np.uint32)  # [row, 32-bit group of k]
    B = np.zeros((8, 8), np.uint32)   # [column, group]
    A[G, T], A[G + 8, T] = a_regs[:, 0], a_regs[:, 1]
    A[G, 4 + T], A[G + 8, 4 + T] = a_regs[:, 2], a_regs[:, 3]
    B[G, T], B[G, 4 + T] = b_regs[:, 0], b_regs[:, 1]
    D = np.bitwise_count(A[:, None, :] & B[None, :, :]).sum(
        -1, dtype=np.int64)
    acc[:, 0] += D[G, 2 * T]
    acc[:, 1] += D[G, 2 * T + 1]
    acc[:, 2] += D[G + 8, 2 * T]
    acc[:, 3] += D[G + 8, 2 * T + 1]


def load4(words32, rows, w0, nw):
    """[32, 4] uint32: a lane's words w0..w0 + 3 of its row, zero past
    the row's nw words (csrc/bits.cu load4)."""
    idx = w0[:, None] + np.arange(4)
    v = words32[rows[:, None], np.minimum(idx, nw - 1)]
    return np.where(idx < nw, v, 0).astype(np.uint32)


def launch_grid(tiles, resident):
    """The kernel's grid: one block a WARPS tiles, at most the card's
    resident blocks."""
    return min(-(-tiles // WARPS), resident)


def warp_tiles(tiles, grid):
    """{(block, warp): its tiles in order}, the kernel's 1-D walk."""
    return {(blk, w): range(blk * WARPS + w, tiles, grid * WARPS)
            for blk in range(grid) for w in range(WARPS)}


def kernel_model(a, b, resident=264):
    """numpy model of csrc/bits.cu, one warp at a time, lanes as arrays:
    rows read as 32-bit words (little-endian halves of a 64-bit word, the
    same for a and b); a warp's tiles of TM x TN from the 1-D walk; per
    16-word chunk, lane (g, t) loads words 4t..4t+3 of each row it feeds
    (rows clamped to NA - 1 and NB - 1, zero past the row) and adds their
    popcounts; two MMAs a chunk, words (4t, 4t+1) then (4t+2, 4t+3) as
    (a0/b0, a2/b1); quad sums and shuffles give popc(a[i]), popc(b[j]);
    count = pa + pb - 2D; the output, float32 1 - count / nbits, looked
    up in the block's table of nbits + 1 (below TABLE_MAX bits) or
    divided, into the staging tile (poisoned with NaN before each
    tile); 16-byte stores of rows for a tile inside [NA, NB] with
    NB % 4 == 0, else masked scalar stores.
    Returns the output (NaN where never stored) and the stores a cell."""
    na, nb = len(a), len(b)
    nbits = np.float32(8 * a.dtype.itemsize * a.shape[1])
    aw = np.ascontiguousarray(a).view(np.uint32)
    bw = np.ascontiguousarray(b).view(np.uint32)
    nw = aw.shape[1]
    tiles_n = -(-nb // TN)
    tiles = -(-na // TM) * tiles_n
    steps = -(-nw // CHUNK)
    out = np.full((na, nb), np.nan, np.float32)
    writes = np.zeros((na, nb), np.int64)
    if nbits < TABLE_MAX:
        table = np.float32(1) - (np.arange(int(nbits) + 1).astype(
            np.float32) / nbits)
    for (_blk, _w), walk in warp_tiles(tiles,
                                       launch_grid(tiles, resident)).items():
        for tile in walk:
            r0, c0 = tile // tiles_n * TM, tile % tiles_n * TN
            acc = np.zeros((2, 8, 32, 4), np.int64)
            pa = np.zeros((2, 2, 32), np.int64)
            pb = np.zeros((8, 32), np.int64)
            for s in range(steps):
                w0 = s * CHUNK + 4 * T
                xa = [[load4(aw, np.minimum(r0 + 16 * m + 8 * h + G, na - 1),
                             w0, nw) for h in (0, 1)] for m in (0, 1)]
                for m in (0, 1):
                    for h in (0, 1):
                        pa[m, h] += np.bitwise_count(xa[m][h]).sum(
                            -1, dtype=np.int64)
                for n in range(8):
                    xb = load4(bw, np.minimum(c0 + 8 * n + G, nb - 1), w0, nw)
                    pb[n] += np.bitwise_count(xb).sum(-1, dtype=np.int64)
                    for m in (0, 1):
                        for k in (0, 2):
                            bmma_and_popc(acc[m, n], np.stack(
                                [xa[m][0][:, k], xa[m][1][:, k],
                                 xa[m][0][:, k + 1], xa[m][1][:, k + 1]], 1),
                                xb[:, k:k + 2])
            for x in (pa, pb):  # __shfl_xor_sync by 1, then by 2
                x += x[..., LANE ^ 1]
                x += x[..., LANE ^ 2]
            stage = np.full((TM, PITCH), np.nan, np.float32)
            for n in range(8):
                p = (pb[n][8 * T], pb[n][8 * T + 4])
                for m in (0, 1):
                    for h in (0, 1):
                        for e in (0, 1):
                            count = (pa[m, h] + p[e]
                                     - 2 * acc[m, n, :, 2 * h + e])
                            stage[16 * m + 8 * h + G, 8 * n + 2 * T + e] = (
                                table[count] if nbits < TABLE_MAX else
                                np.float32(1) - count.astype(np.float32)
                                / nbits)
            if nb % 4 == 0 and r0 + TM <= na and c0 + TN <= nb:
                for i in range(TM // 2):
                    row = 2 * i + (LANE >> 4)
                    for j in range(4):
                        col = 4 * (LANE & 15) + j
                        out[r0 + row, c0 + col] = stage[row, col]
                        writes[r0 + row, c0 + col] += 1
            else:
                rows, cols = min(TM, na - r0), min(TN, nb - c0)
                out[r0:r0 + rows, c0:c0 + cols] = stage[:rows, :cols]
                writes[r0:r0 + rows, c0:c0 + cols] += 1
    return out, writes


@pytest.mark.parametrize("dt", [np.uint32, np.uint64])
@pytest.mark.parametrize("w", [1, 3, 8, 16, 17, 33])
def test_kernel_model_equals_plain(dt, w):
    """Bit-equal to the plain version, every output stored once, at NA
    and NB of 1, 63-65 and 130, with 1-3 resident blocks (so warps walk
    several tiles) and a whole card's 264."""
    rng = np.random.default_rng(w)
    sizes = (1, 63, 64, 65, 130)
    ones = np.iinfo(dt).max
    for na in sizes:
        a = random_words(rng, na, w, dt)
        a[::4] |= dt(1) << dt(8 * np.dtype(dt).itemsize - 1)
        a[-1] = ones
        for nb in sizes:
            b = random_words(rng, nb, w, dt)
            b[0] = ones
            b[-1] = 0
            got, writes = kernel_model(a, b, resident=1 + (na + nb) % 3)
            want = port_sim(a, b)
            assert (writes == 1).all(), (na, nb)
            assert np.array_equal(got.view(np.uint32),
                                  want.view(np.uint32)), (na, nb)
    a, b = random_words(rng, 130, w, dt), random_words(rng, 65, w, dt)
    got, writes = kernel_model(a, b)
    assert (writes == 1).all()
    assert np.array_equal(got.view(np.uint32), port_sim(a, b).view(np.uint32))


@pytest.mark.parametrize("w", [1, 8, 17, 128])
def test_kernel_model_uint64_equals_uint32_view(w):
    """The uint64 words and their uint32 view take one path: the same
    counts, the same floats (at W = 128, 8,192 bits, the kernel that
    divides)."""
    rng = np.random.default_rng(40 + w)
    a = random_words(rng, 70, w, np.uint64)
    b = random_words(rng, 66, w, np.uint64)
    got64, _ = kernel_model(a, b, resident=2)
    got32, _ = kernel_model(a.view(np.uint32), b.view(np.uint32), resident=2)
    assert np.array_equal(got64.view(np.uint32), got32.view(np.uint32))
    counts = np.rint((1.0 - got64.astype(np.float64)) * 64 * w).astype(int)
    assert np.array_equal(counts, popcount_rows(a, b))


@pytest.mark.parametrize("na, nb, resident", [
    (4_200_000, 3, 264), (2047, 129, 264), (1, 1, 264), (8192, 8192, 264),
    (130, 65, 1), (4_194_241, 64, 7)])
def test_tile_walk_covers_every_tile_once(na, nb, resident):
    """The grid and walk of the kernel visit each tile once, at the old
    grid's limit (NA > 65,535 x 64 rows) and past it."""
    tiles = -(-na // TM) * -(-nb // TN)
    grid = launch_grid(tiles, resident)
    assert 1 <= grid <= resident and (grid - 1) * WARPS < tiles
    seen = np.concatenate([np.asarray(r) for r in warp_tiles(
        tiles, grid).values()])
    assert np.array_equal(np.sort(seen), np.arange(tiles))


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
