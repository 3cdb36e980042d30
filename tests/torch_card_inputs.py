"""Inputs, host models and goldens of the port's checks on the card.

The recipes build each input from bench.py's generators and a seed: the
primary workload's repeat mix and repeat rows, filtered2k with its tf-idf
filter file, the ultra-long mix, the Canu blocks, EstimateROC's files and
the scale inputs.  The adversarial and design sets aim at each kernel's
edges.  The host models (the native C++ scorer, a numpy Guava bloom
filter, the mode-2 weights in float64, a numpy popcount) are what the
kernels are held against beside their plain versions.  The goldens are
line counts and sha256 digests of the native binary, the JAX package or
the JAX CLI on the same inputs, each with the script that remakes it.

Used on the card by tests/test_torch_card_kernels.py and
tests/test_torch_card_paths.py, on the CPU by the tests of kernels 5 and
6, and by the scripts that time kernels (scripts/kernel_ab.py) or remake
goldens.  Imports nothing of JAX or of the JAX package, and nothing else
until a function runs.
"""

from __future__ import annotations

import hashlib
import os
import time

EXPECTED_PRIMARY = 4349
EXPECTED_LOGNORMAL10K = 158246
EXPECTED_FILTERED2K = 286410

# the oracle CLI's reads (the first of the primary workload), and the
# seed of kernel 6's [8,192, 8] words
ORACLE_READS = 256
BITS_SEED = 4246
# the Canu path: canu_input(bench, dir, CANU_READS), goldens of
# the JAX package on the CPU (scripts/canu_goldens.py, n = 2,048, 8
# shared CPU cores):
#   JAX_PLATFORMS=cpu python -m mhap_tpu.cli.main -p blocks -q dats
#     -f kmers.txt --supress-noise 2 --repeat-weight 0.9
#     --repeat-idf-scale 10                                     (149 s)
#   ... -s dats/block0.dat -q querydir (block1.dat), same flags (750 s)
#   TpuOverlapper(kmer_filter=VectorFrequencyFilter(FrequencyCounts(f,
#     1e-5, 0.9, 1, False, 10.0, True))).overlap_self(reads)  (1,240 s)
CANU_READS = 2048
CANU_DAT_SHA256 = {
    "block0.dat":
        "fb5ad3da5c04a8e220f0038ac534d34228bd0cd0e95aebf48ea4df9f69258014",
    "block1.dat":
        "64db7021f90a76851fd3c8daad8d54c109156fc18913b1a124fc7db8fd407501"}
CANU_LINES = 302394
CANU_SHA256 = \
    "ecfc6dd97fa5bc3a04789ba49f7c20c03a1cd469c8a62b980c6164d299d91159"
CANU_MODE1_LINES = 505891
CANU_MODE1_SHA256 = \
    "a65504948d9539b3b5336a5c24cd5566906955e8edd771749b4e2d68a8bbabaa"
# the same recipe at 512 reads, mode 2 with the bloom, library
# overlap_self at default settings: the JAX package's golden
CANU512_LINES = 87037
CANU512_SHA256 = \
    "b157c8b5c3da91e7038e57e61fb8e188302cce2d1e976662ba743c30374a2474"
# bench.py's scale inputs, name -> (reads, offset of bench.SEED), built
# by scale_input
SCALE_INPUTS = {"scale40k": (40_000, 3), "scale100k": (100_000, 4),
                "repeat40k": (40_000, 5)}
# their goldens, name -> (lines, line-set sha256): the native reference
# (native/mhap_cpu.cc, bench.bench_native; -f kmers.txt for repeat40k) on
# each input, made on the CPU by scripts/scale_goldens.py (native on 8
# shared CPU cores: 46 s, 146 s and 465 s; 11.7 min in all).  The counts
# are those the JAX package matched (SCALE40K_r05.json,
# SCALE100K_r05.json, REPEAT40K_r05.json)
SCALE_GOLDENS = {
    "scale40k": (632392, "b847801217943966eb2dbfe3bef8aa1a"
                         "9386c6dce195daffc13a044e64a0f3c2"),
    "scale100k": (1587078, "a65cc87433180c10a1dccadba5bb28b7"
                           "88231e81feab2f4fe525bf448d5424e9"),
    "repeat40k": (29493000, "3b0e89146ef79d2e3850a9ad0860661e"
                            "30dc2cf88abe0c5948e446171c439200"),
}
# EstimateROC(min_ovl_len=500, num_trials=2000, do_dp=True) on
# each input's truth (bench.write_truth_m4) and line set, sorted as
# overlap_self returns it: goldens of the JAX package on the CPU
# (scripts/roc_goldens.py, 8 shared CPU cores), estimate_ppv(batch_dp=True)
# with the sha256 of its sw_align_batch outputs (sw_sha256), and the
# stdout of python -m mhap_tpu.tools.estimate_roc truth.m4 ovl.mhap
# reads.fa 500 2000 true (per-pair native DP).  lognormal10k has no
# disputed pair: its truth places every read, so every line's pair is
# in the truth clusters and the batched Smith-Waterman never runs;
# filtered2k's repeat family gives 1,713 (padded to [1,713, 2,889] and
# [1,713, 2,849]: 482 s in JAX on the CPU; its CLI 46 s).
ROC_GOLDENS = {
    "lognormal10k": dict(
        tp=53070, fn=13089, tn=1988, fp=0, sensitivity=0.8021584364939011,
        specificity=1.0, ppv=1.0, disputed=0, sw_sha256=None,
        cli=["Estimated sensitivity:\t0.8022",
             "Estimated specificity:\t1.0000", "Estimated PPV:\t 1.0000"]),
    "filtered2k": dict(
        tp=63463, fn=17716, tn=1697, fp=255, sensitivity=0.7817662203279173,
        specificity=0.8693647540983607, ppv=0.9995, disputed=1713,
        sw_sha256="afcb656e66f0313317156552e4cd176f"
                  "2bf6ed067d5a9fff356ccc92b95cacc0",
        cli=["Estimated sensitivity:\t0.7818",
             "Estimated specificity:\t0.8694", "Estimated PPV:\t 0.9995"]),
}


def reset_counters(kern) -> None:
    for f in kern.values():
        f.launches = 0


def read_counters(kern) -> dict:
    return {name: f.launches for name, f in kern.items()}


def kernels() -> dict:
    """The port's kernel wrappers by name, each with its ``launches``
    counter."""
    from mhap_tpu_torch.ops.bits_kernels import bit_similarity
    from mhap_tpu_torch.ops.merge_kernels import merge2
    from mhap_tpu_torch.ops.minhash_kernels import (min_reduce_w1,
                                                    weighted_min_reduce)
    from mhap_tpu_torch.ops.pack_kernels import pack_strands
    from mhap_tpu_torch.ops.scorer_kernels import score_pairs
    from mhap_tpu_torch.ops.swalign_kernels import sw_align_batch

    return {"min_reduce_w1": min_reduce_w1,
            "weighted_min_reduce": weighted_min_reduce,
            "score_pairs": score_pairs, "merge2": merge2,
            "sw_align_batch": sw_align_batch,
            "bit_similarity_matrix": bit_similarity,
            "pack_strands": pack_strands}


def native_scorer():
    """ctypes handle on native/scorer_ffi.cc mhap_score_pair."""
    import ctypes

    import numpy as np

    from mhap_tpu_torch.utils import native

    fn = native.library().mhap_score_pair
    fn.restype = ctypes.c_int
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    fn.argtypes = [i32p, i32p, ctypes.c_int, ctypes.c_int, i32p, i32p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
                   np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
    return fn


def adversarial_pairs(T: int, S: int, seed: int):
    """Store columns of T sketch pairs (row t of q against row t of c)
    with hashes from tiny value spaces: deep same-hash runs, shift-window
    failures and cursor extensions that real reads rarely reach."""
    import numpy as np

    rng = np.random.default_rng(seed)
    cols = []
    for _side in range(2):
        oh = np.full((T, S), 0x7FFFFFFF, np.int32)
        op = np.full((T, S), 0x7FFFFFFF, np.int32)
        om = np.zeros(T, np.int32)
        nk = rng.integers(10, 3 * S, T).astype(np.int32)
        cols.append((oh, op, om, nk))
    for t in range(T):
        nv = int(rng.integers(3, 400))
        for oh, op, om, nk in cols:
            m = min(S, int(nk[t]))
            h = rng.integers(-nv, nv, m).astype(np.int32)
            p = rng.integers(0, nk[t], m).astype(np.int32)
            o = np.lexsort((p, h))
            oh[t, :m], op[t, :m], om[t] = h[o], p[o], m
    return cols


def scorer_design_pairs(S: int, seed: int):
    """Store columns of kernel-3 pairs aimed at its decomposition (row t
    of q against row t of c), full rows sorted by (hash, pos), 4 pairs of
    each kind:
      run:      S equal hashes each side, one run pair of S x S entries;
      shared:   the same S distinct hashes each side, shifts of 2-6;
      disjoint: no hash shared;
      pos_rep:  20 hash values at 4 positions in q and 30 in c, so runs of
                equal pos1 among the records span hashes.
    Returns (q_cols, c_cols, kinds)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    kinds, sides = [], ([], [])
    for kind in ("run", "shared", "disjoint", "pos_rep"):
        for _ in range(4):
            nk1 = int(rng.integers(S + 100, 3 * S))
            nk2 = int(rng.integers(S + 100, 3 * S))
            p1 = rng.integers(0, nk1, S)
            p2 = rng.integers(0, nk2, S)
            if kind == "run":
                h1 = h2 = np.full(S, rng.integers(-2**31, 2**31 - 1))
            elif kind == "shared":
                h1 = h2 = rng.choice(2**32, S, replace=False) - 2**31
                p1 = rng.integers(0, nk1 - 6, S)
                p2 = p1 + rng.integers(2, 7, S)
                nk2 = nk1
            elif kind == "disjoint":
                h = rng.choice(2**32, 2 * S, replace=False) - 2**31
                h1, h2 = h[:S], h[S:]
            else:
                h1, h2 = rng.integers(0, 20, S), rng.integers(0, 20, S)
                p1, p2 = rng.integers(0, 4, S), rng.integers(0, 30, S)
            for side, (h, p, nk) in zip(sides, ((h1, p1, nk1),
                                                (h2, p2, nk2))):
                o = np.lexsort((p, h))
                side.append((h[o], p[o], nk))
            kinds.append(kind)
    cols = [(np.stack([r[0] for r in side]).astype(np.int32),
             np.stack([r[1] for r in side]).astype(np.int32),
             np.full(len(side), S, np.int32),
             np.array([r[2] for r in side], np.int32)) for side in sides]
    return cols[0], cols[1], kinds


def merge_rows(store, idx):
    """Ordered sketches of store rows ``idx`` as kernel-4 limbs: the hash
    with its sign bit flipped in limb 0 (unsigned order = the signed order
    the rows are sorted in), the position in limb 1, pads all ones."""
    import torch

    idx = idx.long()
    real = (torch.arange(store.ordered_h.shape[1], device=idx.device)[None]
            < store.ordered_m[idx][:, None])
    limb0 = torch.where(real, store.ordered_h[idx] ^ (-(1 << 31)), -1)
    limb1 = torch.where(real, store.ordered_p[idx], -1)
    return limb0.to(torch.int32).contiguous(), \
        limb1.to(torch.int32).contiguous()


def record_chunks(ov) -> list:
    """Makes ``ov._sketch_chunk`` append each (codes, lens) it is handed
    to the list returned."""
    chunks = []
    sketch_chunk = ov._sketch_chunk

    def record(codes, lens):
        chunks.append((codes, lens))
        return sketch_chunk(codes, lens)

    ov._sketch_chunk = record
    return chunks


def candidate_pairs(ov, reads):
    """(store, qg, cand): the reads' sketch store and its candidate pairs
    (query and candidate store rows, numpy), as overlap_self builds them."""
    import numpy as np

    store = ov.sketch_reads(reads)
    qg, cand = ov._candidates(store, ov._build_index(store), store,
                              np.nonzero(store.is_fwd)[0], True)
    return store, qg, cand


def adversarial_merge_rows(T: int, S: int, seed: int):
    """T sorted row pairs at width S: keys equal across a and b (rows
    0-7), all-pad rows, one-entry rows, and full rows of duplicate keys
    around the sign bits of both limbs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    hi_vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE,
                        0xFFFFFFFF], np.uint32)
    lo_vals = np.array([0, 5, 0x80000000, 0xFFFFFFFF], np.uint32)

    def rows(m):
        hi = rng.choice(hi_vals, (T, S))
        lo = rng.choice(lo_vals, (T, S))
        for t in range(T):
            o = np.lexsort((lo[t], hi[t]))
            hi[t], lo[t] = hi[t][o], lo[t][o]
            hi[t, m[t]:] = 0xFFFFFFFF
            lo[t, m[t]:] = 0xFFFFFFFF
        return hi.view(np.int32), lo.view(np.int32)

    m_a = rng.integers(0, S + 1, T)
    m_b = rng.integers(0, S + 1, T)
    m_a[8:12], m_b[8:12] = 0, 0            # both rows all pads
    m_a[12:16], m_b[12:16] = 1, 0          # one entry against pads
    m_a[16:20], m_b[16:20] = 1, 1          # one entry each
    m_a[20:24], m_b[20:24] = S, S          # full rows
    a, b = rows(m_a), rows(m_b)
    b[0][:8], b[1][:8] = a[0][:8], a[1][:8]  # equal keys across a and b
    return a, b


def repeat_mix(bench):
    """256 primary-style reads: 32 carry an internal 500 bp duplication,
    2 an ACGTTGCA x 200 tandem insert."""
    import numpy as np

    reads = bench.make_reads(256)
    rng = np.random.default_rng(bench.SEED + 7)
    for i in rng.choice(256, 34, replace=False).tolist()[:32]:
        r = reads[i]
        a = int(rng.integers(200, len(r) - 700))
        reads[i] = r[:a + 500] + r[a:a + 500] + r[a + 500:]
    for i in (5, 77):
        r = reads[i]
        reads[i] = r[:1200] + "ACGTTGCA" * 200 + r[1200:]
    return reads


def filtered2k_placed(bench):
    """bench.bench_config_filtered's reads: 2,048 reads x 2.9 kb from a
    genome with an implanted repeat family.  Returns (reads, placements,
    genome_len, genome)."""
    n_reads = 2048
    genome_len = int(n_reads * bench.READ_LEN / 25.0)
    genome = bench.repeat_seeded_genome(genome_len, seed=bench.SEED + 2)
    reads, placements, _ = bench.make_reads_placed(
        n_reads, seed=bench.SEED + 2, lognormal=False, genome=genome,
        genome_len=genome_len)
    return reads, placements, genome_len, genome


def filtered2k(bench, tmpdir: str):
    """bench.bench_config_filtered's input: filtered2k_placed's reads and
    their tf-idf filter file (the genome's 4,000 most frequent 16-mers).
    Returns (reads, path)."""
    reads, _, _, genome = filtered2k_placed(bench)
    path = os.path.join(tmpdir, "kmers.txt")
    bench.write_filter_file(genome, 16, path)
    return reads, path


def repeat_rows(reads):
    """Kernel 2's repeat rows: 64 primary reads with a 100 bp segment
    repeated 1-4 times (weights 1..4) and one with an ACGTTGCA x 200
    insert (weights around 200)."""
    rows = []
    for i, r in enumerate(reads[512:576]):
        rep = 1 + i % 4
        rows.append(r[:600] + r[600:700] * rep + r[700:2000])
    rows.append(reads[600][:300] + "ACGTTGCA" * 200 + reads[600][300:600])
    return rows


def write_fasta(path: str, reads) -> str:
    with open(path, "w") as f:
        f.writelines(f">r{i}\n{r}\n" for i, r in enumerate(reads))
    return path


def bloom_member_np(words, bit_size: int, num_hashes: int, keys):
    """Guava's mightContain of int64 keys, in numpy (uint64 arithmetic,
    murmur3_x64_128 of each key's 8 little-endian bytes, seed 0): the
    host's evaluation of the port's bloom filter."""
    import numpy as np

    m = np.uint64(0xFFFFFFFFFFFFFFFF)

    def rotl(x, r):
        return (x << np.uint64(r)) | (x >> np.uint64(64 - r))

    def fmix(x):
        x = x ^ (x >> np.uint64(33))
        x = x * np.uint64(0xFF51AFD7ED558CCD)
        x = x ^ (x >> np.uint64(33))
        x = x * np.uint64(0xC4CEB9FE1A85EC53)
        return x ^ (x >> np.uint64(33))

    with np.errstate(over="ignore"):
        k1 = rotl(keys.view(np.uint64) * np.uint64(0x87C37B91114253D5), 31)
        h1 = (k1 * np.uint64(0x4CF5AD432745937F)) ^ np.uint64(8)
        h2 = np.full_like(h1, 8)
        h1 = h1 + h2
        h2 = h2 + h1
        h1, h2 = fmix(h1), fmix(h2)
        h1 = h1 + h2
        h2 = h2 + h1
        w = words.view(np.uint64)
        out = np.ones(keys.shape, bool)
        comb = h1
        for _ in range(num_hashes):
            p = (comb & (m >> np.uint64(1))) % np.uint64(bit_size)
            out &= ((w[p >> np.uint64(6)] >> (p & np.uint64(63)))
                    & np.uint64(1)).astype(bool)
            comb = comb + h2
    return out


def mode2_weights_np(fc, member, keys, counts):
    """tf-idf weights of --supress-noise 2 in numpy float64: the file's
    scaled idf, range for a k-mer the file lists below the cutoff or not
    at all, 1.0 outside the file (bloom says so); max(1, floor(count *
    sidf + 0.5))."""
    import numpy as np

    fk, fs = fc.keys.numpy(), fc.sidf.numpy()
    i = np.minimum(np.searchsorted(fk, keys), len(fk) - 1)
    sidf = np.where(fk[i] == keys, fs[i], float(fc.range))
    sidf = np.where(member, sidf, 1.0)
    w = np.floor(counts.astype(np.float64) * sidf + 0.5)
    return np.clip(w, 1, (1 << 31) - 1).astype(np.int64)


def canu_input(bench, tmpdir: str, n_reads: int):
    """bench_config_filtered's recipe at n_reads, split into two FASTA
    blocks (``blocks/block0.fa``, ``blocks/block1.fa``, headers ``r<i>``
    numbered across both), and its filter file with the genome's 40,000
    most frequent 16-mers, every one listed (``kmers.txt``, cutoff 0).
    Returns (reads, blocks_dir, filter_path)."""
    genome_len = int(n_reads * bench.READ_LEN / 25.0)
    genome = bench.repeat_seeded_genome(genome_len, seed=bench.SEED + 2)
    reads, _, _ = bench.make_reads_placed(n_reads, seed=bench.SEED + 2,
                                          lognormal=False, genome=genome,
                                          genome_len=genome_len)
    blocks = os.path.join(tmpdir, "blocks")
    os.makedirs(blocks, exist_ok=True)
    half = n_reads // 2
    for b, lo in enumerate((0, half)):
        with open(os.path.join(blocks, f"block{b}.fa"), "w") as f:
            f.writelines(f">r{i}\n{reads[i]}\n"
                         for i in range(lo, lo + half))
    path = os.path.join(tmpdir, "kmers.txt")
    bench.write_filter_file(genome, 16, path, cutoff=0.0, top=40_000)
    return reads, blocks, path


def roc_files(bench, tmpdir: str, reads, placements, genome_len, lines):
    """The three files bench_config_lognormal hands EstimateROC: the truth
    M4 (bench.write_truth_m4), the overlap lines and the reads as FASTA
    numbered from 1.  Returns (truth, overlaps, fasta) paths."""
    truth = os.path.join(tmpdir, "truth.m4")
    ovls = os.path.join(tmpdir, "ovl.mhap")
    fa = os.path.join(tmpdir, "reads.fa")
    bench.write_truth_m4(placements, reads, truth, genome_len)
    with open(ovls, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(fa, "w") as f:
        f.writelines(f">{i + 1}\n{r}\n" for i, r in enumerate(reads))
    return truth, ovls, fa


def estimate_roc_recorded(files):
    """EstimateROC(min_ovl_len=500, num_trials=2000, do_dp=True) on the
    card as bench_config_lognormal runs it, with estimate_ppv(batch_dp=
    True) on roc_files' (truth, overlaps, fasta).  Returns (roc, the
    disputed pairs its batched Smith-Waterman took, PPV seconds, seconds
    to load and estimate sensitivity and specificity)."""
    import torch

    from mhap_tpu_torch.tools.estimate_roc import EstimateROC

    t0 = time.perf_counter()
    roc = EstimateROC(min_ovl_len=500, num_trials=2000, do_dp=True,
                      device="cuda")
    roc.process_reference(files[0])
    roc.load_fasta(files[2])
    roc.process_overlaps(files[1])
    roc.estimate_sensitivity()
    roc.estimate_specificity()
    t1 = time.perf_counter()
    disputed = []
    batch = roc._compute_dp_batch

    def record(pairs):
        disputed.extend(pairs)
        return batch(pairs)

    roc._compute_dp_batch = record
    roc.estimate_ppv(batch_dp=True)
    torch.cuda.synchronize()
    return roc, disputed, time.perf_counter() - t1, t1 - t0


def filtered2k_disputed(bench, tmpdir: str, lines):
    """Kernel 5's inputs on the main path: filtered2k's disputed PPV pairs
    ([1,713, 2,889] and [1,713, 2,849]), made by estimate_roc_recorded
    from the overlapper's sorted ``lines`` on filtered2k_placed's reads."""
    reads, places, glen, _ = filtered2k_placed(bench)
    files = roc_files(bench, tmpdir, reads, places, glen, lines)
    roc, disputed = estimate_roc_recorded(files)[:2]
    return roc.dp_batch_inputs(disputed)[0]


# the eight outputs of sw_align_batch, in the order sw_sha256 hashes them
SW_COLS = ("score", "q_end", "r_end", "q_begin", "r_begin", "matches",
           "errors", "length")


def sw_sha256(out) -> str:
    """sha256 of sw_align_batch's eight [P] columns (numpy or torch), each
    as little-endian int32, in SW_COLS order."""
    import numpy as np

    h = hashlib.sha256()
    for k in SW_COLS:
        v = out[k]
        v = v.cpu().numpy() if hasattr(v, "cpu") else np.asarray(v)
        h.update(v.astype("<i4").tobytes())
    return h.hexdigest()


def dna(rng, n: int) -> bytes:
    import numpy as np

    return bytes(np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, n)])


def mutate_dna(rng, s: bytes, err: float = 0.1) -> bytes:
    """tests/test_swalign.py's error model: insertions, deletions and
    substitutions at err / 3 each."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", np.uint8)
    out = bytearray()
    for ch in s:
        x = rng.random()
        if x < err / 3:
            out.append(ch)
            out.append(bases[rng.integers(0, 4)])
        elif x < 2 * err / 3:
            pass
        elif x < err:
            out.append(bases[rng.integers(0, 4)])
        else:
            out.append(ch)
    return bytes(out)


def sw_adversarial_pairs(seed: int = 7, B: int = 128):
    """Ties and edges for kernel 5: identical, unrelated, homopolymer and
    tandem-repeat runs (many co-optimal paths), N runs, lower case,
    lengths 0, 1, 31, 32, 33 and B - 1, B, B + 1 (B: the kernel's rows a
    stripe), qlen > rlen and the reverse, all in one batch of mixed
    lengths."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = dna(rng, 600)
    return [
        (g[:150], g[:150]),
        (dna(rng, 140), dna(rng, 90)),
        (b"A" * 70, b"A" * 45),
        (b"A" * 40 + b"C" * 40, b"C" * 30 + b"A" * 50),
        (b"ACGTTGCA" * 18, b"ACGTTGCA" * 11),
        (b"CA" * 60, b"AC" * 45),
        (b"ACG" * 40, mutate_dna(rng, b"ACG" * 40, 0.15)),
        (b"N" * 50, b"N" * 33),
        (g[:60] + b"N" * 20 + g[80:140], g[:140]),
        (g[200:300].lower(), g[200:300]),
        (b"", g[:40]),
        (g[:40], b""),
        (b"", b""),
        (b"G", b"G"),
        (b"G", b"T"),
        (g[:31], g[:32]),
        (g[:33], mutate_dna(rng, g[:33])),
        (g[300:300 + B - 1], mutate_dna(rng, g[300:300 + B])),
        (mutate_dna(rng, g[100:100 + B]), g[100:100 + B + 1]),
        (g[:B + 1], g[40:B + 1]),
        (mutate_dna(rng, g[:180]), g[20:90]),
        (g[50:110], mutate_dna(rng, g[:200])),
    ]


def sw_tie_pairs(seed: int = 17, count: int = 16):
    """Short pairs (3-30 bases) over AC and ACGT, each also with its
    roles swapped: many equal scores, so E's and F's extend-on-ties, H's
    diag-F-E order and the best cell's (i, j) order decide the outputs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for c in range(count):
        alpha = np.frombuffer(b"AC" if c % 2 else b"ACGT", np.uint8)
        la, lb = rng.integers(3, 31, 2)
        a = bytes(alpha[rng.integers(0, len(alpha), la)])
        b = bytes(alpha[rng.integers(0, len(alpha), lb)])
        out += [(a, b), (b, a)]
    return out


def sw_long_pairs(seed: int = 4247):
    """Three pairs whose query is longer than 65,535 bases, so kernel 5
    takes its 32-bit stats and the best cell's row and the path's begin
    pass 16 bits: a noisy 66.8 kb stretch of a random genome against noisy
    400-base reads from inside it, one across row 65,536 and one past it,
    and against an unrelated 400 bases."""
    import numpy as np

    rng = np.random.default_rng(seed)
    g = dna(rng, 66_800)
    q = mutate_dna(rng, g)
    return [(q, mutate_dna(rng, g[65_300:65_700])),
            (q, mutate_dna(rng, g[66_100:66_500])), (q, dna(rng, 400))]


def bits_adversarial(seed: int = 13):
    """Word pairs (a [NA, W], b [NB, W]) for kernel 6: NA and NB in {1,
    63, 64, 65} (a tile of 64 rows, one short of it, one past it), W in
    {1, 3, 33} (33 is past a 16-word chunk twice), uint32 and uint64
    words; random words, with the first row of a all zeros and of b all
    ones, the last row of a all ones and of b all zeros, and the top bit
    set in every word of every third row."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = []
    for dt in (np.uint32, np.uint64):
        ones = np.iinfo(dt).max
        top = dt(1) << dt(8 * np.dtype(dt).itemsize - 1)
        for w in (1, 3, 33):
            for na in (1, 63, 64, 65):
                for nb in (1, 63, 64, 65):
                    a = rng.integers(0, ones, (na, w), dtype=dt,
                                     endpoint=True)
                    b = rng.integers(0, ones, (nb, w), dtype=dt,
                                     endpoint=True)
                    a[1::3] |= top
                    b[2::3] |= top
                    a[-1], b[-1] = ones, 0
                    a[0], b[0] = 0, ones
                    out.append((a, b))
    return out


def read_filter(path: str, no_tf: bool = False):
    """The file as bench_config_filtered reads it: cutoff 1e-5, offset
    0.9, remove_unique 0, range 3.0, canonical k-mers."""
    from mhap_tpu_torch.io.fasta import open_text
    from mhap_tpu_torch.io.filter import FrequencyCounts

    with open_text(path) as f:
        return FrequencyCounts(f, 1e-5, 0.9, 0, no_tf, 3.0, True)


def scale_input(bench, name: str, tmpdir: str):
    """bench.py's scale inputs, built as bench_config_scale40k,
    bench_config_scale100k and bench_config_repeat40k build them:
    lognormal reads at 25x of a random genome, or, for repeat40k, of a
    genome ~24% copies of one 2 kb repeat, with its filter file (the
    genome's 4,000 most frequent 16-mers).  Returns (reads, filter path
    or None)."""
    n_reads, seed_offset = SCALE_INPUTS[name]
    seed = bench.SEED + seed_offset
    if name != "repeat40k":
        return bench.make_reads_placed(n_reads, seed=seed)[0], None
    genome_len = int(n_reads * 1550 / 25.0)
    genome = bench.repeat_seeded_genome(genome_len, seed=seed,
                                        repeat_len=2000, n_copies=300)
    reads, _, _ = bench.make_reads_placed(n_reads, seed=seed, genome=genome,
                                          genome_len=genome_len)
    path = os.path.join(tmpdir, "kmers.txt")
    bench.write_filter_file(genome, 16, path)
    return reads, path


def ultra_long_mix(bench, seed: int = 4244, genome_len: int = 1_500_000,
                   lens=None):
    """Seed 4244: 16 reads of 131,072-400,000 bp and 1,024 of 2.9 kb,
    from a 1.5 Mb random genome through bench._noisy_read (or reads of
    ``lens`` from another seed and genome length)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    G = genome_len
    genome = rng.integers(0, 4, G)
    if lens is None:
        lens = rng.integers(131_072, 400_001, 16).tolist() \
            + [bench.READ_LEN] * 1024
    reads = []
    for L in lens:
        span = int(L * 1.15)
        pos = int(rng.integers(0, G - span))
        out, _ = bench._noisy_read(rng, genome[pos:pos + span], L)
        reads.append(bytes(bases[out]).decode("ascii"))
    return reads


def code_rows(seqs, k1: int, dev):
    """Strings or uint8 arrays -> (16-mer hashes [R, n] int64, valid
    [R, n]) on ``dev``, rows padded to the longest."""
    import numpy as np
    import torch

    from mhap_tpu_torch.ops import murmur3

    arrs = [np.frombuffer(x.encode(), np.uint8) if isinstance(x, str)
            else x for x in seqs]
    W = -(-max(map(len, arrs)) // 64) * 64
    codes = np.zeros((len(arrs), W), np.uint8)
    ln = np.zeros(len(arrs), np.int64)
    for i, c in enumerate(arrs):
        codes[i, :len(c)] = c
        ln[i] = len(c)
    h = murmur3.kmer_hashes_128(torch.from_numpy(codes).to(dev), k1)
    valid = (torch.arange(h.shape[1], device=dev)[None]
             < torch.from_numpy(ln - k1 + 1).to(dev)[:, None])
    return h, valid


def primary_hashes(reads, n: int, dev, k1: int = 16):
    """16-mer hashes [n, 2,885] of the first n primary reads (all 2,900
    bases), kernel 1's input at the main path's shape."""
    import numpy as np
    import torch

    from mhap_tpu_torch.ops import murmur3

    codes = np.frombuffer("".join(reads[:n]).encode(), np.uint8)
    return murmur3.kmer_hashes_128(
        torch.from_numpy(codes.reshape(n, -1).copy()).to(dev), k1)


def first_kmers(reads, k1: int, dev):
    """(hashes, counts) of every distinct 16-mer of each strand of
    ``reads`` at its first occurrence (sort_and_count runs' first
    elements), 512 reads per batch."""
    import numpy as np
    import torch

    from mhap_tpu_torch.ops import minhash as mh
    from mhap_tpu_torch.utils.seq import reverse_complement

    keys, counts = [], []
    for s in range(0, len(reads), 512):
        rows = []
        for r in reads[s:s + 512]:
            rows += [r, reverse_complement(r)]
        g = mh.sort_and_count(*code_rows(rows, k1, dev))
        keys.append(g["h"][g["first"]])
        counts.append(g["count"][g["first"]])
    return torch.cat(keys), torch.cat(counts)


def weighted_inputs(h, valid, weights=None):
    """Kernel 2's arguments as the main path builds them from k-mer hashes
    (ops/minhash.py minhash_weighted_rows, or minhash_filtered_rows with
    the filter's ``weights``): (sorted hashes, weight, active, tiebreak)."""
    import torch

    from mhap_tpu_torch.ops import minhash as mh

    g = mh.sort_and_count(h, valid)
    w = g["count"] if weights is None else weights(g["h"], g["count"])
    w = torch.where(g["first"], w, 0)
    return g["h"], w, g["first"] & (w > 0), g["tiebreak"]


def design_rows(dev, heavy_min: int) -> dict:
    """Kernel-2 inputs aimed at its three passes (numpy seed 21; random
    hashes, weights 1-3, distinct tiebreaks):
      edges: one row of 3,000 with k-mers at heavy_min - 1, heavy_min,
             heavy_min + 1 and 1,000 (H = 32, so the plain version is fast);
      ties:  two rows of 20,000 where equal hashes at equal weights sit in
             two segments and among heavy k-mers (row 0 holds only those);
      long:  [4, 400,000], 400,000 / 150,000 / 6,000 / 50 active k-mers,
             1 in 500 at weights heavy_min .. heavy_min + 8;
      w30000: two rows of 3,000 with k-mers at 30,000 and 10,000.
    Returns {name: ((h, weight, active, tiebreak), H)}."""
    import numpy as np
    import torch

    rng = np.random.default_rng(21)

    def rows(B, n):
        return (rng.integers(-2**63, 2**63 - 1, (B, n), dtype=np.int64),
                rng.integers(1, 4, (B, n)).astype(np.int32),
                np.ones((B, n), bool),
                np.stack([rng.permutation(n) for _ in range(B)]).astype(
                    np.int32))

    out = {}
    h, w, a, tb = rows(1, 3000)
    w[0, 10:13], w[0, 100:103] = heavy_min - 1, heavy_min
    w[0, 1000:1003], w[0, 2000] = heavy_min + 1, 1000
    out["edges"] = ((h, w, a, tb), 32)
    h, w, a, tb = rows(2, 20000)
    for r, c1, c2, wt in ((0, 100, 10000, 3), (0, 200, 15000, heavy_min + 5),
                          (1, 50, 9000, 2), (1, 60, 19000, heavy_min + 9)):
        h[r, c2] = h[r, c1]
        w[r, [c1, c2]] = wt
    a[0] = False
    a[0, [100, 10000, 200, 15000]] = True
    out["ties"] = ((h, w, a, tb), 512)
    h, w, a, tb = rows(4, 400_000)
    heavy = rng.random(h.shape) < 1 / 500
    w[heavy] = rng.integers(heavy_min, heavy_min + 9, int(heavy.sum()))
    for r, m in enumerate((400_000, 150_000, 6_000, 50)):
        a[r, m:] = False
    out["long"] = ((h, w, a, tb), 512)
    h, w, a, tb = rows(2, 3000)
    w[0, 5:8], w[0, 8], w[1, 2999] = 30_000, 10_000, 30_000
    out["w30000"] = ((h, w, a, tb), 512)
    return {k: (tuple(torch.from_numpy(x).to(dev) for x in args), H)
            for k, (args, H) in out.items()}


def np_xor_popcount(a, b, rows: int = 256):
    """numpy popcount(a[i] ^ b[j]) summed over the words, int64 [NA, NB],
    a block of rows at a time (np.bitwise_count: numpy 2.0 on)."""
    import numpy as np

    out = np.empty((len(a), len(b)), np.int64)
    for r in range(0, len(a), rows):
        x = a[r:r + rows, None, :] ^ b[None, :, :]
        out[r:r + rows] = np.bitwise_count(x).sum(-1, dtype=np.int64)
    return out
