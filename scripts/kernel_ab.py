#!/usr/bin/env python3
"""Times kernels 1-6 of one tree's ``mhap_tpu_torch`` at the main path's
shapes on the GPU, so that two trees can be compared in one call:

    python3 scripts/kernel_ab.py PARENT_TREE    # then CHANGE, CHANGE, PARENT
    python3 scripts/kernel_ab.py TREE --kernels 5   # only kernel 5
    python3 scripts/kernel_ab.py TREE --kernels 6   # only kernel 6

Imports ``mhap_tpu_torch`` from the tree given (its kernels build into
that tree's ``mhap_tpu_torch/build``) and the inputs' recipes (``bench``)
from this checkout.  Shapes: kernel 1 on the primary workload's first
512 reads [512, 2,885] at H = 512; kernel 2 on chip_smoke.py phase 2's
repeat rows [65, 2,289] and on the first filtered2k chunk [1,024, 2,929]
at its tf-idf weights; kernel 3 on all of filtered2k's candidate pairs
at S = 1,536; kernel 4 on the ordered sketches (``chip_smoke.merge_rows``)
of the primary workload's first 4,096 candidate pairs and of
lognormal10k's first 32,768, [T, 1,536] -> [T, 3,072], timed three
ways: through the wrapper, as a call of its C entry on preallocated
outputs (the wrapper's checks and allocations left out), and as 20
wrapper calls back to back over 20 (the host's time a call hidden behind
the card's queue); kernel 5 on filtered2k's 1,713 disputed PPV pairs
([1,713, 2,889] and [1,713, 2,849]), made as chip_smoke.py phase 12 makes
them (the tree's overlapper and EstimateROC), its eight outputs' sha256
beside the JAX golden; kernel 6 on the primary workload's 1-bit MinHash
sketches (chip_smoke.py phase 13's main path: [2,048, 8] uint64 all
against all, and their uint32 view) and on [8,192, 8] uint64 words of
chip_smoke.BITS_SEED, through the wrapper and as the card's time alone
(chip_smoke.device_ms: 20 calls queued behind a sleep kernel, so the
host's time a call drops out), each with the sha256 of its output.
CUDA events, median of 5 after a warm-up.  Prints one JSON line with the
card's nvidia-smi name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def queued_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the time of n back-to-back fn() calls / n."""
    return time_ms(lambda: [fn() for _ in range(n)], reps) / n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree")
    ap.add_argument("--kernels", default="1,2,3,4,5,6",
                    help="comma-separated kernel numbers to time")
    a = ap.parse_args()
    tree = os.path.abspath(a.tree)
    which = {int(k) for k in a.kernels.split(",")}
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import bench
    from chip_smoke import (BITS_SEED, ROC_GOLDENS, candidate_pairs,
                            device_ms, filtered2k_disputed, merge_rows,
                            sw_sha256)

    sys.path.insert(0, tree)
    import mhap_tpu_torch
    from mhap_tpu_torch.io.filter import FrequencyCounts
    from mhap_tpu_torch.ops import _build
    from mhap_tpu_torch.ops import minhash as mh
    from mhap_tpu_torch.ops import murmur3
    from mhap_tpu_torch.ops.merge_kernels import merge2
    from mhap_tpu_torch.ops.minhash_kernels import (min_reduce_w1,
                                                    weighted_min_reduce)
    from mhap_tpu_torch.ops.scorer_kernels import score_pairs
    from mhap_tpu_torch.ops.swalign_kernels import sw_align_batch
    from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
    from mhap_tpu_torch.pipeline.overlapper import (TorchOverlapper,
                                                    _rc_codes)

    assert mhap_tpu_torch.__file__.startswith(tree), mhap_tpu_torch.__file__
    dev = torch.device("cuda")
    k1, H = 16, 512

    def rows_of(seqs):
        arrs = [np.frombuffer(x.encode(), np.uint8) if isinstance(x, str)
                else x for x in seqs]
        W = -(-max(map(len, arrs)) // 64) * 64
        codes = np.zeros((len(arrs), W), np.uint8)
        ln = np.zeros(len(arrs), np.int64)
        for i, c in enumerate(arrs):
            codes[i, :len(c)] = c
            ln[i] = len(c)
        h = murmur3.kmer_hashes_128(torch.from_numpy(codes).to(dev), k1)
        return h, (torch.arange(h.shape[1], device=dev)[None]
                   < torch.from_numpy(ln - k1 + 1).to(dev)[:, None])

    def weighted(h, valid, weights=None):
        g = mh.sort_and_count(h, valid)
        w = g["count"] if weights is None else weights(g["h"], g["count"])
        w = torch.where(g["first"], w, 0)
        return g["h"], w, g["first"] & (w > 0), g["tiebreak"]

    out = {"tree": tree}
    reads = bench.make_reads()
    if 1 in which:
        h, _ = rows_of(reads[:512])
        act = torch.ones_like(h, dtype=torch.bool)
        out["k1 [512, 2885] H=512"] = time_ms(
            lambda: min_reduce_w1(h, act, H))
    if 2 in which:
        rows = []
        for i, r in enumerate(reads[512:576]):
            rows.append(r[:600] + r[600:700] * (1 + i % 4) + r[700:2000])
        rows.append(reads[600][:300] + "ACGTTGCA" * 200
                    + reads[600][300:600])
        args = weighted(*rows_of(rows))
        out["k2 phase 2 rows [65, 2289]"] = time_ms(
            lambda: weighted_min_reduce(*args, H))
    if which & {2, 3, 5}:
        genome_len = int(2048 * bench.READ_LEN / 25.0)
        genome = bench.repeat_seeded_genome(genome_len, seed=bench.SEED + 2)
        reads_f, _, _ = bench.make_reads_placed(
            2048, seed=bench.SEED + 2, lognormal=False, genome=genome,
            genome_len=genome_len)
        with tempfile.TemporaryDirectory() as td:
            path = os.path.join(td, "kmers.txt")
            bench.write_filter_file(genome, 16, path)
            with open(path) as f:
                fc = FrequencyCounts(f, 1e-5, 0.9, 0, False, 3.0, True)
        vf = VectorFrequencyFilter(fc, dev)
    if 2 in which:
        strands = []
        for r in reads_f[:512]:
            c = np.frombuffer(r.encode(), np.uint8)
            strands += [c, _rc_codes(c)]
        args = weighted(*rows_of(strands),
                        lambda k, c: vf.weights(k, c, 0.9))
        out["k2 filtered2k chunk [1024, 2929]"] = time_ms(
            lambda: weighted_min_reduce(*args, H))
    if 3 in which:
        store, qg, cand = candidate_pairs(
            TorchOverlapper(device="cuda", kmer_filter=vf), reads_f)
        qi = torch.from_numpy(qg.astype(np.int32)).to(dev)
        ci = torch.from_numpy(cand.astype(np.int32)).to(dev)
        cols = store.scorer_cols()
        out[f"k3 filtered2k {len(qg)} pairs S=1536"] = time_ms(
            lambda: score_pairs(cols, cols, qi, ci, 0.2))
        del store, cols
    k4_rows = (("primary", reads, 4096),
               ("lognormal10k", bench.make_reads_placed(
                   10_000, seed=bench.SEED + 1)[0], 32768)) \
        if 4 in which else ()
    for name, rs, n in k4_rows:
        store, qg, cand = candidate_pairs(TorchOverlapper(device="cuda"),
                                          rs)
        qi = torch.from_numpy(qg[:n].astype(np.int32)).to(dev)
        ci = torch.from_numpy(cand[:n].astype(np.int32)).to(dev)
        ma = merge_rows(store, qi) + merge_rows(store, ci)
        o = torch.empty((2, n, 3072), dtype=torch.int32, device=dev)
        args = [x.data_ptr() for x in ma] + [n, 1536, 3072,
                                             o[0].data_ptr(), o[1].data_ptr()]
        lib = _build.kernels()
        stream = torch.cuda.current_stream().cuda_stream
        key = f"k4 {name} [{n}, 1536] -> 3072"
        out[key] = time_ms(lambda: merge2(*ma, out_width=3072))
        out[key + " C entry"] = time_ms(
            lambda: _build.check(lib.mhap_merge2(*args, stream), "merge2"))
        out[key + " queued"] = queued_ms(lambda: merge2(*ma, out_width=3072))
        if not all(map(torch.equal, o, merge2(*ma, out_width=3072))):
            raise AssertionError(f"{key}: C entry differs from the wrapper")
        del store, ma, o
    if 5 in which:
        lines = TorchOverlapper(device="cuda", kmer_filter=vf).overlap_self(
            reads_f)
        with tempfile.TemporaryDirectory() as td:
            args = filtered2k_disputed(bench, td, lines)
        key = (f"k5 filtered2k {len(args[1])} disputed pairs "
               f"{list(args[0].shape)} x {list(args[2].shape)}")
        out[key] = time_ms(lambda: sw_align_batch(*args))
        out[key + " sha256 equal to the JAX golden"] = (
            sw_sha256(sw_align_batch(*args))
            == ROC_GOLDENS["filtered2k"]["sw_sha256"])
    if 6 in which:
        from mhap_tpu_torch.ops.bits import words
        from mhap_tpu_torch.ops.bits_kernels import bit_similarity
        from mhap_tpu_torch.sketches.bits import pack_last_bits_msb_first

        store = TorchOverlapper(device="cuda").sketch_reads(reads)
        bits64 = pack_last_bits_msb_first(
            store.host("minhash")[store.header_id != 0])
        big = np.random.default_rng(BITS_SEED).integers(
            0, np.iinfo(np.uint64).max, (2, 8192, 8), dtype=np.uint64,
            endpoint=True)
        bits32 = bits64.view(np.uint32)
        for name, x, y in (("primary 1-bit sketches", bits64, bits64),
                           ("their uint32 view", bits32, bits32),
                           ("seeded words", big[0], big[1])):
            ka, kb = words(x, dev), words(y, dev)
            key = f"k6 {name} {list(x.shape)} x {list(y.shape)}"
            out[key] = time_ms(lambda: bit_similarity(ka, kb))
            out[key + " device"] = device_ms(lambda: bit_similarity(ka, kb))
            out[key + " sha256"] = hashlib.sha256(
                bit_similarity(ka, kb).cpu().numpy().tobytes()
            ).hexdigest()[:16]
        del store
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
