"""Each CUDA kernel of the port bit-equal to its plain version on the card.

Kernels 1-6 at the main path's shapes and on inputs aimed at their
edges (tests/torch_card_inputs.py), and past the shared-memory limits
where a kernel's scratch moves to device memory (the plan is checked to
say so); kernel 2's outputs equal at every heavy-k-mer threshold; kernel
3 also against the native C++ scorer; kernel 6's uint64 counts against a
numpy popcount; the device filter weights against the host's float64
ones.  The strand pack's card tests are in test_torch_sketch_pack.py.

Every case names its kernel, so ``-k kernel3`` runs one.  They need a
CUDA card and skip without one.  On the card, where JAX is absent and
tests/conftest.py imports it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_card_kernels.py

Imports nothing of JAX or of the JAX package.
"""

import numpy as np
import pytest
import torch

import torch_card_inputs as ci

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs a CUDA card")]

K1, H, S = 16, 512, 1536
# kernel 2's heavy-k-mer thresholds the outputs must not depend on
HEAVY_MIN_GRID = (16, 32, 64, 128)


@pytest.fixture(scope="module")
def bench():
    import bench

    return bench


@pytest.fixture(scope="module")
def dev():
    return torch.device("cuda")


@pytest.fixture(scope="module")
def reads(bench):
    return bench.make_reads()


@pytest.fixture(scope="module")
def primary(reads):
    """(store, qg, cand) of the primary workload."""
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    return ci.candidate_pairs(TorchOverlapper(device="cuda"), reads)


@pytest.fixture(scope="module")
def filtered(bench, tmp_path_factory):
    """filtered2k's reads, filter file and its counts."""
    reads_f, path = ci.filtered2k(bench,
                                  str(tmp_path_factory.mktemp("filtered")))
    return reads_f, path, ci.read_filter(path)


@pytest.fixture(scope="module")
def filtered_ov(filtered):
    from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    return TorchOverlapper(device="cuda", kmer_filter=VectorFrequencyFilter(
        filtered[2], "cuda"))


@pytest.fixture(scope="module")
def lognormal10k(bench):
    """(store, qg, cand) of lognormal10k."""
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    reads = bench.make_reads_placed(10_000, seed=bench.SEED + 1)[0]
    return ci.candidate_pairs(TorchOverlapper(device="cuda"), reads)


@pytest.fixture(scope="module")
def long_pairs(bench):
    """(store, qg, cand) of the ultra-long mix's 16 long reads at an
    ordered sketch size S (70,000+ ordered 12-mers a strand), by S."""
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    reads = ci.ultra_long_mix(bench)[:16]
    cache = {}

    def get(size):
        if size not in cache:
            cache[size] = ci.candidate_pairs(TorchOverlapper(
                dict(ordered_sketch_size=size), device="cuda"), reads)
        return cache[size]
    return get


@pytest.fixture(scope="module")
def design(dev):
    from mhap_tpu_torch.ops.minhash_kernels import HEAVY_MIN

    return ci.design_rows(dev, HEAVY_MIN)


@pytest.mark.parametrize("case", ["primary", "random_masks", "h16384"])
def test_kernel1(case, request, dev):
    """[512, 2,885] at H = 512; random rows [6, 9,000] with masks and an
    empty row; four reads at H = 16,384 (bests in device memory)."""
    from mhap_tpu_torch.ops import minhash as mh
    from mhap_tpu_torch.ops.minhash_kernels import min_reduce_w1, plan

    num_hashes = 16384 if case == "h16384" else H
    if case == "random_masks":
        g = torch.Generator(device=dev).manual_seed(11)
        h = torch.randint(-2**63, 2**63 - 1, (6, 9000), device=dev,
                          dtype=torch.int64, generator=g)
        act = torch.rand((6, 9000), device=dev, generator=g) < 0.7
        act[2] = False
        act[3, 5000:] = False
    else:
        reads = request.getfixturevalue("reads")
        h = ci.primary_hashes(reads, 512 if case == "primary" else 4, dev)
        act = torch.ones_like(h, dtype=torch.bool)
    if case == "h16384":
        assert plan(1, num_hashes)["path"] == "device"
    before = min_reduce_w1.launches
    got = min_reduce_w1(h, act, num_hashes)
    assert min_reduce_w1.launches == before + 1
    assert torch.equal(got, mh.min_reduce_w1_ref(h, act, num_hashes))


def filtered_top4(filtered, dev):
    """Kernel 2's arguments on the 4 of filtered2k's first 512 reads with
    the largest tf-idf weights."""
    from mhap_tpu_torch.ops import minhash as mh
    from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter

    reads_f, _path, fc = filtered
    vf = VectorFrequencyFilter(fc, dev)
    g = mh.sort_and_count(*ci.code_rows(reads_f[:512], K1, dev))
    w = torch.where(g["first"], vf.weights(g["h"], g["count"], 0.9), 0)
    top = torch.topk(w.max(dim=1).values, 4).indices
    return g["h"][top], w[top], w[top] > 0, g["tiebreak"][top]


@pytest.mark.parametrize("case", [
    "repeat_rows", "design_edges", "design_ties", "design_long",
    "design_w30000", "filtered2k_top4", "h2048", "h16384"])
def test_kernel2(case, request, dev):
    """The repeat rows (weights 1-4, and ~200 in a tandem row); the
    design rows aimed at the three passes; filtered2k's rows of largest
    tf-idf weight; three repeat rows at H = 2,048 and 16,384 (the light
    pass's bests in device memory), there also with every k-mer of weight
    2 or more through the heavy pass."""
    from mhap_tpu_torch.ops import minhash as mh
    from mhap_tpu_torch.ops.minhash_kernels import plan, weighted_min_reduce

    num_hashes = H
    if case.startswith("design_"):
        args, num_hashes = request.getfixturevalue("design")[case[7:]]
    elif case == "filtered2k_top4":
        args = filtered_top4(request.getfixturevalue("filtered"), dev)
    else:
        rows = ci.repeat_rows(request.getfixturevalue("reads"))
        if case != "repeat_rows":
            rows, num_hashes = rows[1:4], int(case[1:])
        args = ci.weighted_inputs(*ci.code_rows(rows, K1, dev))
    got = weighted_min_reduce(*args, num_hashes)
    if case == "design_w30000":
        # the plain version steps each k-mer's stream 30,000 times: held
        # against the kernel's light pass alone
        want = weighted_min_reduce(*args, num_hashes,
                                   heavy_min=int(args[1].max()) + 1)
    else:
        want = mh.weighted_min_reduce_ref(*args, num_hashes)
    assert torch.equal(got, want)
    if case == "design_long":  # its heavy k-mers in slabs of 100
        assert torch.equal(weighted_min_reduce(*args, num_hashes, slab=100),
                           got)
    if num_hashes > H:
        assert plan(2, num_hashes)["path"] == "device"
        assert torch.equal(weighted_min_reduce(*args, num_hashes,
                                               heavy_min=2), got)


def first_chunk(ov, reads):
    """The first (codes, lens) that ``sketch_reads`` hands _sketch_chunk."""
    chunks = ci.record_chunks(ov)
    try:
        ov.sketch_reads(reads)
    finally:
        del ov._sketch_chunk
    return chunks[0]


@pytest.mark.parametrize("case", ["repeat_rows", "repeat_mix",
                                  "filtered2k_chunk"])
def test_kernel2_heavy_min(case, request, dev):
    """The outputs at every heavy_min of HEAVY_MIN_GRID equal the
    default's: on the repeat rows, on the repeat mix's strands with a
    repeated k-mer, and on filtered2k's first sketch chunk at its tf-idf
    weights (there also equal to the light pass alone)."""
    from mhap_tpu_torch.ops import minhash as mh
    from mhap_tpu_torch.ops import murmur3
    from mhap_tpu_torch.ops.minhash_kernels import weighted_min_reduce
    from mhap_tpu_torch.utils.seq import reverse_complement

    if case == "repeat_rows":
        args = ci.weighted_inputs(*ci.code_rows(
            ci.repeat_rows(request.getfixturevalue("reads")), K1, dev))
    elif case == "repeat_mix":
        strands = []
        for r in ci.repeat_mix(request.getfixturevalue("bench")):
            strands += [r, reverse_complement(r)]
        h, v = ci.code_rows(strands, K1, dev)
        dup = mh.dup_rows(h, v)
        args = ci.weighted_inputs(h[dup], v[dup])
    else:
        ov = request.getfixturevalue("filtered_ov")
        codes, lens = first_chunk(ov, request.getfixturevalue("filtered")[0])
        h = murmur3.kmer_hashes_128(codes, K1)
        v = (torch.arange(h.shape[1], device=dev)[None]
             < (lens - K1 + 1)[:, None])
        args = ci.weighted_inputs(h, v, ov._weights)
    want = weighted_min_reduce(*args, H)
    for heavy_min in HEAVY_MIN_GRID:
        assert torch.equal(weighted_min_reduce(*args, H,
                                               heavy_min=heavy_min), want)
    if case == "filtered2k_chunk":
        assert torch.equal(weighted_min_reduce(
            *args, H, heavy_min=int(args[1].max()) + 1), want)


def test_filter_weights_equal_the_host(filtered, dev):
    """Device weights equal the host's float64 ones for every (k-mer,
    count) of filtered2k's strands in tf-idf, legacy and no-tf modes, and
    for counts 1..10,000 of 2,048 keys."""
    from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter

    reads_f, path, fc = filtered
    vf, vf_host = (VectorFrequencyFilter(fc, d) for d in (dev, "cpu"))
    keys, counts = ci.first_kmers(reads_f, K1, dev)
    for rw in (0.9, -1.0):
        assert torch.equal(vf.weights(keys, counts, rw).cpu(),
                           vf_host.weights(keys.cpu(), counts.cpu(), rw))
    fc_notf = ci.read_filter(path, no_tf=True)
    assert torch.equal(
        VectorFrequencyFilter(fc_notf, dev).weights(keys, counts, 0.9).cpu(),
        VectorFrequencyFilter(fc_notf, "cpu").weights(keys.cpu(),
                                                      counts.cpu(), 0.9))
    syn = torch.cat([vf.keys[:1024], keys[:1024]])
    sk = syn[:, None].expand(-1, 10_000).reshape(-1)
    sc = torch.arange(1, 10_001, device=dev)[None, :].expand(
        len(syn), -1).reshape(-1)
    assert torch.equal(vf.weights(sk, sc, 0.9).cpu(),
                       vf_host.weights(sk.cpu(), sc.cpu(), 0.9))


def native_check(host_q, host_c, qi, ci_, out):
    """Lanes where kernel-3 output ``out`` disagrees with the native C++
    scorer on pairs (host_q[qi[t]], host_c[ci_[t]])."""
    from mhap_tpu_torch.pipeline.overlapper import jaccard_to_identity

    fn = ci.native_scorer()
    bad = 0
    for t, (q, c) in enumerate(zip(qi, ci_)):
        buf = np.zeros(6, np.float64)
        m1, m2 = int(host_q[2][q]), int(host_c[2][c])
        ok = fn(np.ascontiguousarray(host_q[0][q, :m1]),
                np.ascontiguousarray(host_q[1][q, :m1]), m1,
                int(host_q[3][q]), np.ascontiguousarray(host_c[0][c, :m2]),
                np.ascontiguousarray(host_c[1][c, :m2]), m2,
                int(host_c[3][c]), 12, 0.2, buf)
        row = out[t]
        if bool(ok) != bool(row[0]):
            bad += 1
        elif ok:
            ident = jaccard_to_identity(row[1] / max(row[2], 1), 12)
            if (ident, float(row[3]), *row[4:8].tolist()) != (
                    buf[0], buf[1], *[int(x) for x in buf[2:6]]):
                bad += 1
    return bad


def to_card(cols, dev):
    return [torch.from_numpy(x).to(dev) for x in cols]


@pytest.mark.parametrize("case", ["primary", "adversarial", "design",
                                  "lognormal10k", "filtered2k", "s10000",
                                  "s70000"])
def test_kernel3(case, request, bench, dev):
    """The first 4,096 candidate pairs of the primary workload,
    lognormal10k and filtered2k; 256 adversarial pairs (deep same-hash
    runs); the design pairs aimed at the block decomposition; 8 and 2
    ultra-long pairs at S = 10,000 and 70,000 (scratch in device
    memory).  The primary, adversarial and design pairs also against the
    native scorer."""
    from mhap_tpu_torch.ops.scorer import score_pairs_ref
    from mhap_tpu_torch.ops.scorer_kernels import plan, score_pairs

    host = None
    if case in ("adversarial", "design"):
        if case == "adversarial":
            host = ci.adversarial_pairs(256, S, seed=bench.SEED)
        else:
            host = ci.scorer_design_pairs(S, seed=bench.SEED + 5)[:2]
        q_cols, c_cols = (to_card(x, dev) for x in host)
        n = len(host[0][0])
        qg = cand = np.arange(n)
    else:
        if case.startswith("s"):
            size, n = int(case[1:]), 8 if case == "s10000" else 2
            store, qg, cand = request.getfixturevalue("long_pairs")(size)
            assert plan(size)["path"] == "device"
        else:
            n = 4096
            if case == "filtered2k":
                store, qg, cand = ci.candidate_pairs(
                    request.getfixturevalue("filtered_ov"),
                    request.getfixturevalue("filtered")[0])
            else:
                store, qg, cand = request.getfixturevalue(
                    "primary" if case == "primary" else case)
        assert len(qg) >= n
        qg, cand = qg[:n], cand[:n]
        q_cols = c_cols = store.scorer_cols()
        if case == "primary":
            host = [[store.host(k) for k in ("ordered_h", "ordered_p",
                                             "ordered_m", "num_kmers")]] * 2
    qi = torch.from_numpy(qg.astype(np.int32)).to(dev)
    cj = torch.from_numpy(cand.astype(np.int32)).to(dev)
    got = score_pairs(q_cols, c_cols, qi, cj, 0.2)
    ql, cl = qi.long(), cj.long()
    want = score_pairs_ref(*[c[ql] for c in q_cols],
                           *[c[cl] for c in c_cols], 0.2)
    assert torch.equal(got, want)
    if host is not None:
        assert native_check(host[0], host[1], qg, cand,
                            got.cpu().numpy()) == 0


@pytest.mark.parametrize("case", ["primary", "adversarial", "unaligned",
                                  "lognormal10k", "s10000", "s70000"])
def test_kernel4(case, request, bench, dev):
    """The ordered sketches of the primary workload's first 4,096
    candidate pairs, [4,096, 1,536] -> 3,072, and cut to 1,535 columns
    (rows not 16-byte aligned: the cp.async path); 37 adversarial row
    pairs; lognormal10k's first 32,768 pairs; 64 row pairs at S = 10,000
    (OW = 2S) and 4 at S = 70,000 (OW = S) of ultra-long sketches."""
    from mhap_tpu_torch.ops import merge as mg
    from mhap_tpu_torch.ops.merge_kernels import merge2, occupancy

    ow = None
    if case == "adversarial":
        (a0, a1), (b0, b1) = ci.adversarial_merge_rows(37, S, bench.SEED)
        rows = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                for x in (a0, a1, b0, b1)]
    elif case.startswith("s"):
        size = int(case[1:])
        store = request.getfixturevalue("long_pairs")(size)[0]
        n, ow = (64, 2 * size) if size == 10_000 else (4, size)
        r = torch.arange(n, device=dev)
        n_st = store.ordered_h.shape[0]
        rows = (ci.merge_rows(store, r % n_st)
                + ci.merge_rows(store, (r * 7 + n + 3) % n_st))
    else:
        n = 32768 if case == "lognormal10k" else 4096
        store, qg, cand = request.getfixturevalue(
            "lognormal10k" if case == "lognormal10k" else "primary")
        assert len(qg) >= n
        qi, cj = (torch.from_numpy(x[:n].astype(np.int32)).to(dev)
                  for x in (qg, cand))
        rows = ci.merge_rows(store, qi) + ci.merge_rows(store, cj)
        if case == "unaligned":
            rows = [x[:, :S - 1].contiguous() for x in rows]
            assert occupancy(S - 1)["path"] == "async"
    got = merge2(*rows, out_width=ow)
    want = mg.merge2_ref(*rows, ow)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def disputed(bench, filtered, filtered_ov, tmp_path_factory):
    """Kernel 5's inputs on the main path: filtered2k's disputed PPV
    pairs."""
    lines = filtered_ov.overlap_self(filtered[0])
    return ci.filtered2k_disputed(
        bench, str(tmp_path_factory.mktemp("roc")), lines)


@pytest.mark.parametrize("case", [
    "adversarial", "filtered2k_disputed", "filtered2k_cut2000",
    pytest.param("long", marks=pytest.mark.slow)])
def test_kernel5(case, request, dev):
    """The adversarial set (lengths around a warp's stripe) with the
    tie-heavy short pairs; filtered2k's 1,713 disputed pairs, and their
    first 8 cut to 2,000 bases; three pairs of a 66.8 kb query, whose
    stats take 32 bits and whose best rows pass 16 bits (``slow``: the
    plain scan's time follows n + m, ~90 s)."""
    from mhap_tpu_torch.ops import swalign_kernels as swk
    from mhap_tpu_torch.ops.swalign import pack_pairs
    from mhap_tpu_torch.ops.swalign import sw_align_batch as sw_plain

    if case in ("adversarial", "long"):
        pairs = (ci.sw_adversarial_pairs(B=swk.STRIPE) + ci.sw_tie_pairs()
                 if case == "adversarial" else ci.sw_long_pairs())
        args = [torch.from_numpy(x).to(dev) for x in pack_pairs(pairs)]
    else:
        args = request.getfixturevalue("disputed")
        assert len(args[1]) == ci.ROC_GOLDENS["filtered2k"]["disputed"]
        if case == "filtered2k_cut2000":
            args = [args[0][:8, :2000].contiguous(),
                    args[1][:8].clamp(max=2000),
                    args[2][:8, :2000].contiguous(),
                    args[3][:8].clamp(max=2000)]
    before = swk.sw_align_batch.launches
    got = swk.sw_align_batch(*args)
    assert swk.sw_align_batch.launches == before + 1
    want = sw_plain(*args)
    for k in ci.SW_COLS:
        assert torch.equal(got[k], want[k]), k
    if case == "long":
        n, m = args[0].shape[1], args[2].shape[1]
        assert not swk.packed_stats(n, m, 2, 1)
        assert int(got["q_end"][:2].min()) >= 65_536


def check_kernel6(a, b, dev):
    """Kernel 6 on words a [NA, W] and b [NB, W]: bit-equal to its plain
    version, and on uint64 words each count equal to numpy's popcount."""
    from mhap_tpu_torch.ops.bits import bit_similarity_ref, words
    from mhap_tpu_torch.ops.bits_kernels import bit_similarity

    ka, kb = words(a, dev), words(b, dev)
    got = bit_similarity(ka, kb)
    assert torch.equal(got.view(torch.int32),
                       bit_similarity_ref(ka, kb).view(torch.int32))
    if a.dtype == np.uint64:
        c = np.rint((1.0 - got.cpu().double().numpy()) * 64 * a.shape[1])
        assert (c.astype(np.int64) == ci.np_xor_popcount(a, b)).all()
    return got


def rand_words(rng, n, w, dt):
    return rng.integers(0, np.iinfo(dt).max, (n, w), dtype=dt, endpoint=True)


@pytest.mark.parametrize("case", [
    "adversarial", "primary_sketches", "seeded_8192", "ragged_u64",
    "ragged_u32", "past_table_u64", "past_table_u32", "grid_limit"])
def test_kernel6(case, request, dev):
    """The adversarial set; the primary reads' 1-bit MinHash sketches all
    against all through sketches.bits.bit_similarity_matrix ([2,048, 8]
    uint64 and their uint32 view, equal); [8,192, 8] x [8,192, 8] uint64
    words of BITS_SEED; ragged sets; rows past the kernel's output table
    (8,192 bits or more), one set unaligned; [4,200,000, 8] x [3, 8],
    past the parent design's grid limit."""
    from mhap_tpu_torch.ops.bits_kernels import bit_similarity
    from mhap_tpu_torch.sketches.bits import (bit_similarity_matrix,
                                              pack_last_bits_msb_first)

    rng = np.random.default_rng(ci.BITS_SEED)
    u32, u64 = np.uint32, np.uint64
    if case == "adversarial":
        for a, b in ci.bits_adversarial():
            check_kernel6(a, b, dev)
        return
    if case == "primary_sketches":
        store = request.getfixturevalue("primary")[0]
        bits64 = pack_last_bits_msb_first(
            store.host("minhash")[store.header_id != 0])
        bits32 = bits64.view(np.uint32)
        before = bit_similarity.launches
        sim64 = bit_similarity_matrix(bits64, bits64)
        sim32 = bit_similarity_matrix(bits32, bits32)
        assert bit_similarity.launches == before + 2
        assert torch.equal(sim64, sim32)
        assert torch.equal(check_kernel6(bits64, bits64, dev), sim64)
        assert torch.equal(check_kernel6(bits32, bits32, dev), sim32)
        return
    sets = {"seeded_8192": ((8192, 8, u64), (8192, 8, u64)),
            "ragged_u64": ((2047, 8, u64), (129, 8, u64)),
            "ragged_u32": ((2047, 17, u32), (129, 17, u32)),
            "past_table_u64": ((130, 129, u64), (65, 129, u64)),
            "past_table_u32": ((2048, 257, u32), (130, 257, u32)),
            "grid_limit": ((4_200_000, 8, u64), (3, 8, u64))}[case]
    check_kernel6(*(rand_words(rng, *s) for s in sets), dev)
