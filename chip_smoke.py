#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mhap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from mhap_tpu_torch/csrc (one nvcc per source, all
at once), then:
  1. prints the card (nvidia-smi name and power limit), torch and CUDA
     versions and the kernel build time;
  2. holds each kernel against its plain PyTorch version on the card, at
     the main path's shapes, bit for bit (all outputs are integers), and
     times both (CUDA events, median of 5; 3 for kernel 2's slow plain
     version): kernel 1 also on random rows (masks, an empty row); kernel
     2 also on the filtered2k rows with the largest tf-idf weights and on
     inputs aimed at its three passes (design_rows: weights around
     HEAVY_MIN and at 1,000, forced ties across segments and heavy
     k-mers, rows of 400,000 k-mers with uneven active counts, and
     weights of 30,000, held there against the kernel's light pass
     alone; heavy k-mers also in slabs of 100), with its time at each
     shape and by heavy_min, all outputs bit-equal;
     kernel 3 also against the native C++ scorer (native/scorer_ffi.cc
     mhap_score_pair), on adversarial pairs and on pairs aimed at its
     block decomposition (scorer_design_pairs: one run of S equal hashes
     each side, S shared distinct hashes, no shared hash, positions
     repeated across hashes), with its registers, shared memory and
     resident blocks per SM; kernel 4 (merge2, no
     caller on the overlap path, as in JAX) on the ordered sketches of
     4,096 primary candidate pairs, on 37 adversarial row pairs and on
     the sketches cut to 1,535 columns (rows not 16-byte aligned: its
     cp.async path), with its path and occupancy.  The
     device filter weights equal the host float64 ones for every (k-mer,
     count) of filtered2k and for counts up to 10,000;
  3. runs TorchOverlapper.overlap_self on the primary workload
     (bench.make_reads(): 1,024 reads x 2.9 kb): 4,349 lines whose
     line-set sha256 equals the native binary's on the same reads; then
     the CLI in this process at --settings 2 and 3, each line set equal
     to native's at the flags the preset expands to (cli/options.PRESETS);
  4. a repeat mix (256 reads, 32 with an internal 500 bp duplication, 2
     with an ACGTTGCA x 200 tandem insert): line set equal to native's;
     kernel 2 on its repeat strands by heavy_min;
  5. lognormal10k (bench.make_reads_placed(10_000, seed=SEED + 1)):
     158,246 lines, line set equal to native's; kernel 3 timed on the
     run's whole candidate list, with its bound, and held against its
     plain version on the first 4,096 pairs; kernel 4 on the ordered
     sketches of the first 32,768 pairs, [32,768, 1,536] -> [32,768,
     3,072];
  6. filtered2k (bench.bench_config_filtered's reads and tf-idf filter
     file, read by the port's reader at --supress-noise 0): 286,410 lines,
     line set equal to the native binary's with -f; the CLI's
     ``-s reads.fa -f kmers.txt`` prints the same lines; kernel 2 timed
     on the run's first chunk as _sketch_chunk builds it, with its bound,
     and by heavy_min; kernel 3 as in phase 5;
  7. an ultra-long mix (seed 4244: 16 reads of 131,072-400,000 bp and
     1,024 of 2.9 kb from a 1.5 Mb genome): line set equal to native's,
     and kernel 2's time on the long rows with its light-pass grid
     (blocks, segments, heavy k-mers);
  8. 24 reads of 380,000-403,000 bp (seed 4245, a 2 Mb genome): their 48
     strands exceed TorchOverlapper.CELLS, so sketch_reads cuts them into
     a chunk filled to the budget and a rest; line set equal to native's,
     and the run's peak device memory;
  9. shape limits, where the kernels' scratch moves from shared to device
     memory: kernel 3 at S = 10,000 and 70,000 on 8 and 2 candidate pairs
     of phase 7's long reads, kernel 4 past its parent design's S <= 7,264
     on those reads' sketches (64 row pairs at S = 10,000, OW = 2S; 4 at
     S = 70,000, OW = S), kernel 2 at H = 2,048 and 16,384 on three of
     phase 2's repeat rows (also with every k-mer heavy), kernel 1 at
     H = 16,384 on four primary reads, each bit-equal to its plain
     version (timed once), with its path and footprint; then the CLI in
     this process at --ordered-sketch-size 10000 (24 reads of 12-20 kb),
     --num-hashes 2048 (primary) and --num-hashes 16384 (repeat mix),
     each line set equal to native's at the same flags;
 10. the Canu path at the width users run (k = 16, H = 512, S = 1,536,
     -f kmers.txt --supress-noise 2 --repeat-weight 0.9
     --repeat-idf-scale 10): canu_input's 2,048 reads in two FASTA blocks
     and its filter file; the CLI as subprocesses, -p blocks/ -q dats/
     then -s dats/block0.dat -q querydir/ (block1.dat): each .dat and
     the 302,394 lines sha256-equal to the JAX CLI's (CANU_* below), and
     -s block0.fa -q block1.fa the same lines but for the query ids a
     .dat keeps from -p time; the same two steps in this process with
     launches, cold and steady wall and peak memory, the device bloom
     membership and mode-2 weights of every -p chunk bit-equal to a numpy
     evaluation on the host, kernel 2 timed on the first chunk and held
     against its plain version on its 4 heaviest rows, kernel 3 timed on
     the query candidate pairs; a mode-1 library run (the exact set) of
     all 2,048 reads against its JAX golden (505,891 lines); and mode 2
     with the bloom on the recipe's 512 reads (87,037 lines, the JAX
     package's sha256);
 11. the sharded path (mhap_tpu_torch/parallel): ShardedOverlapper at
     world size 1 on NCCL on lognormal10k (line set equal to native's,
     stats equal to phase 5's, walls beside phase 5's); 2 and 4 gloo
     ranks sharing the card (spawned by parallel/launch.run_ranks after
     the kernels are built here) on the primary reads and, at 2,
     filtered2k with its filter, each rank's launches, peak memory and
     postings bytes logged and the launches counted; the CLI's
     --backend sharded as a subprocess, and under torchrun with one rank
     a card when the machine has 2 or more (scripts/sharded_check.py
     runs NCCL ranks at D = 2 and every card);
 12. EstimateROC (mhap_tpu_torch/tools/estimate_roc.py) and kernel 5,
     the batched Smith-Waterman (csrc/swalign.cu, a block of 4 warps a
     pair): its registers, spills and resident warps per SM in both stat
     layouts;
     kernel 5 bit-equal to its plain version on the CPU test's adversarial
     set (lengths around its stripe of 32 x 4 rows, and short tie-heavy
     pairs); EstimateROC(min_ovl_len=500, num_trials=2000, do_dp=True,
     device="cuda") as
     bench.bench_config_lognormal runs it, with estimate_ppv(batch_dp=
     True), on phase 5's lognormal10k and phase 6's filtered2k (its
     repeat family gives 1,713 disputed pairs, which go through kernel 5;
     lognormal10k has none), each with its truth (bench.write_truth_m4):
     tp, fn, tn, fp, sensitivity, specificity, PPV, the disputed count
     and the sha256 of kernel 5's eight output columns equal to the JAX
     package's goldens (ROC_GOLDENS); lognormal10k's per-pair PPV (the
     native library) beside it, and the tool's CLI as a subprocess, its
     stdout equal to the JAX tool's; kernel 5 timed on filtered2k's
     disputed pairs, on the first 8 cut to 2,000 bases and on three
     pairs of a 66.8 kb query (400-base reads across and past its row
     65,536, and an unrelated one: the kernel's 32-bit stats, the best
     row past 16 bits; the plain version run once), bit-equal to its
     plain version on all, with its bound (SW_OPS_PER_CELL over the
     card's integer issue rate) and GCUPS;
 13. kernel 6, the bit-sketch similarity matrix (csrc/bits.cu), bit-equal
     to its plain version on the CPU test's adversarial set, on the 1-bit
     MinHash sketches of the primary reads (sketch_reads, then the last
     bit of each of the 512 slots packed MSB-first: [2,048, 8] uint64,
     and its [2,048, 16] uint32 view, all against all, through
     sketches/bits.bit_similarity_matrix) and on [8,192, 8] x [8,192, 8]
     uint64 words of BITS_SEED, each uint64 count equal to a numpy
     popcount, timed with its bound (its AND-popcount product as int8
     tensor-core MACs, against its output's bytes; the popcount bound of
     the kernel before beside it), its occupancy, and an fp16 matmul of
     the unpacked 0/1 rows as the product's yardstick; also ragged sets
     ([2,047, 8] x [129, 8] uint64, W = 17 uint32), rows past the
     kernel's output table (8,192 bits or more, which divide) and a set
     past the parent design's grid limit, [4,200,000, 8] x [3, 8]; then
     ``--backend oracle`` through the CLI as a subprocess on the first
     ORACLE_READS primary reads, its line set's sha256 equal to the
     device CLI's and the native binary's on the same file;
 14. scale40k and scale100k (bench.py's 40,000 and 100,000 lognormal
     reads, 80,000 and 200,000 store rows: past the 65,535 rows where the
     JAX package leaves its narrow vote for the wide join-vote), each
     through TorchOverlapper().overlap_self once cold and once split
     into stages (profile_stages.stage_times), and the CLI's -s in this
     process on scale40k: 632,392 and 1,587,078 lines, every line set
     sha256-equal to the native goldens (SCALE_GOLDENS); store rows,
     candidate pairs, hits, the largest hit chunk, cold and steady wall,
     peak device memory (the whole run's and the vote's), the process's
     peak host RSS and the stage split printed.
Every launch counter is set to 0 right before each main-path run of
phases 3-14 and read right after (each rank of phase 11's
launches does so itself); a kernel of a path that did not launch
there fails the run, and so does a device-memory path of phase 9 that
phase 9's CLI runs did not launch.  The bound of each kernel is the
larger of its bytes
(each input read once, each output written once) over 3.35 TB/s and its
integer operations over the card's INT32 rate (kernel 5: over its
integer issue rate, ALU and FMA pipes together; kernel 6: 2 K operations
an output over the card's dense int8 tensor-core rate).  The entries of
kernels 2, 3, 5 and 6 also list their time and bound at each shape timed
(``timings``); the line also lists the device-memory paths of phase 9,
at their first shape past the shared-memory limit.  The last
stdout lines are the kernels' JSON line, the card's nvidia-smi line and
{"ok": true, "device": ...}.  Any failure exits non-zero.  Imports nothing of JAX or
of the JAX package.  profile_stages.py builds its filtered2k input with
filtered2k() and read_filter() from here, so both measure one input.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
EXPECTED_PRIMARY = 4349
EXPECTED_LOGNORMAL10K = 158246
EXPECTED_FILTERED2K = 286410
MEM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT32_LANES_PER_SM = 64    # Hopper SM (NVIDIA H100 white paper)
# integer instructions an SM can start a clock: four schedulers issue one
# warp instruction each, to the ALU pipe or to the FMA pipe (where IMAD
# runs), and a fused DPX instruction takes one slot (kernel 5's rate)
INT_ISSUE_PER_SM_CLOCK = 128
# population-count results a clock on an SM of compute capability 9.0
# (CUDA C++ Programming Guide, arithmetic instruction throughput): kernel
# 6's bound before its tensor-core design, kept beside the new one
POPC_PER_SM_CLOCK = 16
# dense int8 tensor-core operations (a MAC as two) a clock on an SM: the
# H100 SXM data sheet's 1,979 T op/s over 132 SMs at the 1,830 MHz clock
# its tensor rates are quoted at.  sm_rate multiplies it by the card's
# maximum SM clock as nvidia-smi reports it (1,980 MHz on this part), as it
# does the other per-clock rates, so the rate it gives is above the data
# sheet's and the bound errs low
TC_INT8_OPS_PER_SM_CLOCK = 8192
# bit operations (an AND-popcount MAC as two) a clock on an SM through
# mma.sync m16n8k256 b1 .and.popc, the instruction of kernel 6: by the PTX
# ISA's shapes it covers 8x the k of the s8 m16n8k32 MMA, and
# scripts/mma_routes.cu measured both issuing ~0.59 MMAs a clock an SM on
# an H100 (b1 5,035-5,111 T bit-MAC/s, s8 623-642 T MAC/s), so the b1 rate
# is 8x the int8 one.  Kernel 6's bound counts its product, NA x NB x K bit
# MACs, at this rate
TC_B1_OPS_PER_SM_CLOCK = 8 * TC_INT8_OPS_PER_SM_CLOCK
# phase 13: the oracle CLI's reads (the first of the primary workload),
# and the seed of kernel 6's [8,192, 8] words
ORACLE_READS = 256
BITS_SEED = 4246
# INT32 operations per xorshift64 stream step of csrc/minhash.cu: three
# 64-bit shifts and three xors on 32-bit halves (12), the signed 64-bit
# compare and select of the running minimum (4)
OPS_PER_STREAM_STEP = 16
# kernel 2's heavy-k-mer thresholds timed beside the default
HEAVY_MIN_GRID = (16, 32, 64, 128)
# phase 10, the Canu path: canu_input(bench, dir, CANU_READS), goldens of
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
# INT32 operations a cell that kernel 5's function needs at least (loop,
# stripe and team bookkeeping left out), the path stats in two words
# (L << 16 | M, Q << 16 | R) and a fused DPX max one operation: H -
# gap_open once for the E and F it feeds (1); E and F each a subtract and
# a max with its extend flag (4), their stats two selects and an add (6);
# the diagonal's byte compare, score select and add (3), its H == 0
# compare, stats' two selects and add, begin select and the cell's
# position (6); H = max(diag, E, F, 0) (1) and its stats' two compares
# and four selects (6); the running best's max with its flag and three
# selects (4).  Over INT_ISSUE_PER_SM_CLOCK, not the INT32 lanes' 64: the
# kernel's IMADs run on the FMA pipe beside them
SW_OPS_PER_CELL = 31
# phase 12, EstimateROC(min_ovl_len=500, num_trials=2000, do_dp=True) on
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
# phase 14 and scripts/torch_scale_check.py: bench.py's scale inputs,
# name -> (reads, offset of bench.SEED), built by scale_input
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


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi(query: str = "name,power.limit") -> str:
    r = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def sm_rate(per_sm_clock: int) -> float:
    """SMs x ``per_sm_clock`` operations x the card's maximum SM clock, a
    second: INT32_LANES_PER_SM, INT_ISSUE_PER_SM_CLOCK, POPC_PER_SM_CLOCK
    or TC_B1_OPS_PER_SM_CLOCK."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    return sms * per_sm_clock * mhz * 1e6


def bound(nbytes: float, nops: float, rate: float) -> dict:
    """The least ms the card could take for the work, and what sets it."""
    t_bytes = nbytes / MEM_BYTES_PER_S * 1e3
    t_ops = nops / rate * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int = 5) -> float:
    """Median of ``reps`` CUDA-event timings of fn() (after one warm-up)."""
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


def device_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the card's time for n fn() calls back to
    back, over n: a sleep kernel queued first covers the host's time of
    the calls, so the events hold only the launches' device time."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4_000_000)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def max_err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def reset_counters(kern) -> None:
    for f in kern.values():
        f.launches = 0


def read_counters(kern) -> dict:
    return {name: f.launches for name, f in kern.items()}


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


def native_check(fn, host_q, host_c, qi, ci, out, jaccard_to_identity):
    """Lanes where kernel-3 output ``out`` disagrees with the native C++
    scorer on pairs (host_q[qi[t]], host_c[ci[t]])."""
    import numpy as np

    bad = 0
    for t, (q, c) in enumerate(zip(qi, ci)):
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
    """Phase 2's repeat rows: 64 primary reads with a 100 bp segment
    repeated 1-4 times (weights 1..4) and one with an ACGTTGCA x 200
    insert (weights around 200)."""
    rows = []
    for i, r in enumerate(reads[512:576]):
        rep = 1 + i % 4
        rows.append(r[:600] + r[600:700] * rep + r[700:2000])
    rows.append(reads[600][:300] + "ACGTTGCA" * 200 + reads[600][300:600])
    return rows


def once_ms(fn) -> float:
    """One synchronised run of fn(), in ms (the plain versions at large
    shapes take seconds a run)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def cli_in_process(argv):
    """The port's CLI run in this process (its launch counters count):
    (sorted stdout lines, seconds)."""
    import contextlib
    import io

    from mhap_tpu_torch.cli.main import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main([str(a) for a in argv])
    if rc != 0:
        raise AssertionError(f"CLI {argv} exited {rc}: {err.getvalue()}")
    return sorted(out.getvalue().splitlines()), time.perf_counter() - t0


def cli_process(argv):
    """The port's CLI as a subprocess: (sorted stdout lines, seconds,
    the process included)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "mhap_tpu_torch.cli.main",
                        *map(str, argv)], cwd=REPO, capture_output=True,
                       text=True)
    if r.returncode != 0:
        raise AssertionError(f"CLI {argv} exited {r.returncode}: "
                             f"{r.stderr[-3000:]}")
    return sorted(r.stdout.splitlines()), time.perf_counter() - t0


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
    ([1,713, 2,889] and [1,713, 2,849]), made as phase 12 makes them from
    the overlapper's sorted ``lines`` on filtered2k_placed's reads."""
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


def first_kmers(reads, k1: int, dev):
    """(hashes, counts) of every distinct 16-mer of each strand of
    ``reads`` at its first occurrence (sort_and_count runs' first
    elements), 512 reads per batch."""
    import numpy as np
    import torch

    from mhap_tpu_torch.ops import minhash as mh
    from mhap_tpu_torch.pipeline.overlapper import _rc_codes

    keys, counts = [], []
    for s in range(0, len(reads), 512):
        rows = []
        for r in reads[s:s + 512]:
            c = np.frombuffer(r.encode(), np.uint8)
            rows += [c, _rc_codes(c)]
        g = mh.sort_and_count(*code_rows(rows, k1, dev))
        keys.append(g["h"][g["first"]])
        counts.append(g["count"][g["first"]])
    return torch.cat(keys), torch.cat(counts)


def check_filtered(reads_f, filter_path, fc, k1: int, H: int, dev):
    """filtered2k on the card: device filter weights against the host's
    float64 ones (tf-idf, legacy and no-tf modes, every (k-mer, count) of
    the reads, and counts 1..10,000 for 2,048 keys), and kernel 2 against
    its plain version on the 4 rows with the largest tf-idf weights.
    Returns (weights that differ, kernel 2's max |err|)."""
    import torch

    from mhap_tpu_torch.ops import minhash as mh
    from mhap_tpu_torch.ops.minhash_kernels import weighted_min_reduce
    from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter

    vf = VectorFrequencyFilter(fc, dev)
    vf_host = VectorFrequencyFilter(fc, "cpu")
    keys, counts = first_kmers(reads_f, k1, dev)
    bad_w = 0
    for rw in (0.9, -1.0):
        bad_w += int((vf.weights(keys, counts, rw).cpu()
                      != vf_host.weights(keys.cpu(), counts.cpu(), rw)).sum())
    fc_notf = read_filter(filter_path, no_tf=True)
    bad_w += int((VectorFrequencyFilter(fc_notf, dev).weights(
        keys, counts, 0.9).cpu() != VectorFrequencyFilter(
        fc_notf, "cpu").weights(keys.cpu(), counts.cpu(), 0.9)).sum())
    syn_keys = torch.cat([vf.keys[:1024], keys[:1024]])
    sk = syn_keys[:, None].expand(-1, 10_000).reshape(-1)
    sc = torch.arange(1, 10_001, device=dev)[None, :].expand(
        len(syn_keys), -1).reshape(-1)
    w_dev = vf.weights(sk, sc, 0.9)
    bad_w += int((w_dev.cpu() != vf_host.weights(sk.cpu(), sc.cpu(),
                                                 0.9)).sum())
    log(f"[2] filter weights: {len(fc)} file k-mers, {len(keys)} "
        f"(k-mer, count) of filtered2k in modes tf-idf / legacy / no-tf, "
        f"{len(sk)} synthetic (counts 1..10,000, max weight "
        f"{int(w_dev.max())}): {bad_w} device weights differ from host")
    gf = mh.sort_and_count(*code_rows(reads_f[:512], k1, dev))
    wf = torch.where(gf["first"], vf.weights(gf["h"], gf["count"], 0.9), 0)
    top = torch.topk(wf.max(dim=1).values, 4).indices
    fargs = (gf["h"][top], wf[top], (wf[top] > 0), gf["tiebreak"][top])
    err = max_err([weighted_min_reduce(*fargs, H)],
                  [mh.weighted_min_reduce_ref(*fargs, H)])
    log(f"[2] kernel 2 on the 4 filtered2k rows with the largest tf-idf "
        f"weights (max {int(wf.max())}): max|err| {err}")
    return bad_w, err


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


def k2_timing(name: str, args, H: int, rate: float, reps: int = 5,
              **kw) -> dict:
    """Kernel 2's time on ``args`` beside its bound (bytes: 17 a k-mer in,
    4 a slot out; operations: H * sum of active weights stream steps)."""
    from mhap_tpu_torch.ops.minhash_kernels import weighted_min_reduce

    h, w, a, _tb = args
    ms = time_ms(lambda: weighted_min_reduce(*args, H, **kw), reps)
    return dict(input=name, shape=list(h.shape), H=H, ms=ms, **kw,
                **bound(h.numel() * 17 + h.shape[0] * H * 4,
                        int(w[a].sum()) * H * OPS_PER_STREAM_STEP, rate))


def k2_sweep(args, H: int, key: str, values) -> tuple:
    """Kernel 2's ms at each value of one internal argument (heavy_min),
    and the largest |difference| of its outputs from those at the first
    value."""
    from mhap_tpu_torch.ops.minhash_kernels import weighted_min_reduce

    first = weighted_min_reduce(*args, H, **{key: values[0]})
    err = max(max_err([weighted_min_reduce(*args, H, **{key: v})], [first])
              for v in values)
    ms = {v: round(time_ms(lambda: weighted_min_reduce(
        *args, H, **{key: v})), 4) for v in values}
    return ms, err


def k3_timing(name: str, q_cols, c_cols, qi, ci, rate: float,
              reps: int = 5) -> dict:
    """Kernel 3's time on pairs (q row qi[t], c row ci[t]) beside its
    bound.  Bytes: each distinct store row the pairs gather, read once
    (its real (hash, pos) entries and two counts), and two indices and 16
    output columns a pair.  Operations: two merge passes, ~8 INT32 ops a
    cursor step over both rows' real entries."""
    import torch

    from mhap_tpu_torch.ops.scorer_kernels import score_pairs

    ql, cl = qi.long(), ci.long()
    m_sum = int(q_cols[2][ql].sum() + c_cols[2][cl].sum())
    if q_cols is c_cols:
        groups = ((q_cols, torch.unique(torch.cat([ql, cl]))),)
    else:
        groups = ((q_cols, torch.unique(ql)), (c_cols, torch.unique(cl)))
    row_bytes = sum(int(cols[2][d].sum()) * 8 + len(d) * 8
                    for cols, d in groups)
    T = len(qi)
    ms = time_ms(lambda: score_pairs(q_cols, c_cols, qi, ci, 0.2), reps)
    return dict(input=name, pairs=T, ms=ms, row_bytes=row_bytes,
                cursor_steps=2 * m_sum,
                **bound(row_bytes + T * (2 * 4 + 16 * 4), 2 * m_sum * 8,
                        rate))


def k3_run_pairs(name: str, pairs, rate: float, n_check: int = 4096):
    """Kernel 3 on a run's whole candidate list (``candidate_pairs``): its
    timing and bound, and its max |err| against the plain version on the
    first ``n_check`` pairs, with the plain version's time there."""
    import numpy as np
    import torch

    from mhap_tpu_torch.ops.scorer import score_pairs_ref
    from mhap_tpu_torch.ops.scorer_kernels import score_pairs

    store, qg, cand = pairs
    cols = store.scorer_cols()
    dev = cols[0].device
    qi = torch.from_numpy(qg.astype(np.int32)).to(dev)
    ci = torch.from_numpy(cand.astype(np.int32)).to(dev)
    ql, cl = qi[:n_check].long(), ci[:n_check].long()
    gathered = [c[ql] for c in cols] + [c[cl] for c in cols]
    err = max_err([score_pairs(cols, cols, qi[:n_check], ci[:n_check], 0.2)],
                  [score_pairs_ref(*gathered, 0.2)])
    timing = k3_timing(f"{name}: all candidate pairs", cols, cols, qi, ci,
                       rate)
    timing[f"plain_ms_first_{n_check}"] = time_ms(
        lambda: score_pairs_ref(*gathered, 0.2), reps=3)
    return err, timing


def k4_timing(name: str, ma, OW: int, rate: float, reps: int = 5,
              plain: bool = True) -> dict:
    """Kernel 4 on rows ma = (a0, a1, b0, b1) [T, S] -> OW outputs: its
    max |err| against the plain version, its time beside its bound, the
    plain version's and torch.sort's (on the packed keys) times, and the
    path and occupancy it ran with.  Bytes: four [T, S] limb inputs read
    once, two [T, OW] outputs written once; operations: one 64-bit
    compare-select an output, 2 INT32 ops, the least a merge does (so
    bytes bind at every shape)."""
    import torch

    from mhap_tpu_torch.ops import merge as mg
    from mhap_tpu_torch.ops.merge_kernels import merge2, occupancy

    T, S = ma[0].shape
    want = []
    plain_ms = once_ms(lambda: want.append(mg.merge2_ref(*ma, OW)))
    err = max_err(merge2(*ma, out_width=OW), want[0])
    del want
    ms = time_ms(lambda: merge2(*ma, out_width=OW), reps)
    packed = torch.cat([mg.pack_keys(ma[0], ma[1]),
                        mg.pack_keys(ma[2], ma[3])], dim=1)
    library_ms = time_ms(lambda: torch.sort(packed, dim=1), reps)
    del packed
    if plain:
        plain_ms = time_ms(lambda: mg.merge2_ref(*ma, OW), reps)
    return dict(input=name, shape=[T, S], out_width=OW, err=err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                occupancy=occupancy(S, OW),
                **bound(T * S * 4 * 4 + 2 * T * OW * 4, 2 * T * OW, rate))


def run_main_path(ov, reads, kern, n_timed: int = 3):
    """Cold run with counters reset before and read after, one settling
    run, then ``n_timed`` timed runs.  Returns (lines, counts, cold_s,
    steady_s, peak_bytes)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters(kern)
    t0 = time.perf_counter()
    lines = ov.overlap_self(reads)
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    counts = read_counters(kern)
    ov.overlap_self(reads)
    times = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        again = ov.overlap_self(reads)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if again != lines:
            raise AssertionError("overlap_self is not deterministic")
    return (lines, counts, cold, statistics.median(times),
            torch.cuda.max_memory_allocated())


def peak_rss_bytes() -> int:
    """This process's peak resident host memory so far."""
    import resource

    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def check_scale(bench, name: str, lines) -> None:
    """Raises unless ``lines`` is the native golden of scale input
    ``name``: its count and its line-set sha256."""
    want_n, want_sha = SCALE_GOLDENS[name]
    sha = bench.lineset_sha256(lines)
    if len(lines) != want_n or sha != want_sha:
        raise AssertionError(f"{name}: {len(lines)} lines, sha256 {sha}; "
                             f"native {want_n} lines, sha256 {want_sha}")


def scale_run(bench, ov, reads, name: str, kern, need, n_settle: int,
              n_timed: int) -> dict:
    """overlap_self on scale input ``name``: a cold run with the launch
    counters reset before and read after, ``n_settle`` settling runs, a
    run split into stages (profile_stages.stage_times), then ``n_timed``
    timed runs.  Every run's line set is held against the golden
    (check_scale, outside the timed span); a kernel of ``need`` that the
    cold run did not launch raises.  Each run's wall goes to stderr as it
    ends.  Returns the numbers, times in seconds."""
    import torch

    from profile_stages import stage_times

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lines = ov.overlap_self(reads)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        print(f"[scale] {name}: a run took {secs:.3f} s, peak RSS "
              f"{peak_rss_bytes() / 2**30:.3f} GiB", file=sys.stderr,
              flush=True)
        return lines, secs

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    elements = ov.stats["elements_processed"]
    reset_counters(kern)
    lines, cold = run()
    counts = read_counters(kern)
    res = dict(input=name, reads=len(reads), cold_s=cold, launches=counts,
               peak_device_bytes=torch.cuda.max_memory_allocated(),
               elements_processed=ov.stats["elements_processed"] - elements,
               largest_hit_chunk=ov.largest_hit_chunk)
    check_scale(bench, name, lines)
    res["lines"] = len(lines)
    del lines
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise AssertionError(f"{name}: the path skipped {missing}: {counts}")
    res["settle_s"] = []
    for _ in range(n_settle):
        lines, secs = run()
        check_scale(bench, name, lines)
        del lines
        res["settle_s"].append(secs)
    T, pairs, lines, info = stage_times(ov, reads)
    check_scale(bench, name, lines)
    del lines
    res.update(candidate_pairs=pairs, stages_s=T, **info)
    res["steady_runs_s"] = []
    for _ in range(n_timed):
        lines, secs = run()
        check_scale(bench, name, lines)
        del lines
        res["steady_runs_s"].append(secs)
    res["steady_s"] = (statistics.median(res["steady_runs_s"]) if n_timed
                       else T["total"])
    res["peak_rss_bytes"] = peak_rss_bytes()
    return res


def scale_summary(res: dict) -> str:
    """scale_run's numbers on one line."""
    stages = ", ".join(f"{k} {v:.3f}" for k, v in res["stages_s"].items())
    runs = ", ".join(f"{s:.3f}" for s in res["steady_runs_s"])
    return (f"{res['input']}: {res['reads']:,} reads, {res['store_rows']:,} "
            f"store rows, {res['candidate_pairs']:,} candidate pairs, "
            f"{res['elements_processed']:,} hits (elements_processed), "
            f"largest hit chunk {res['largest_hit_chunk']:,} hits; "
            f"{res['lines']:,} lines sha256-equal to native; cold "
            f"{res['cold_s']:.3f} s, settle {res['settle_s']}, steady "
            f"{res['steady_s']:.3f} s" + (f" (median of {runs})" if runs
                                          else "")
            + f"; peak device memory {res['peak_device_bytes'] / 2**30:.3f}"
            f" GiB (vote {res['vote_peak_bytes'] / 2**30:.3f} GiB), host "
            f"peak RSS {res['peak_rss_bytes'] / 2**30:.3f} GiB; launches "
            f"{res['launches']}; stages (s) {stages}")


def scale_phase(bench, kern, add, tmpdir: str) -> None:
    """Phase 14: TorchOverlapper().overlap_self on scale40k and scale100k
    (a cold run and a steady run split into stages, scale_run), and the
    CLI in this process on scale40k, each line set equal to the native
    golden; kernels 1 and 3 launch in each."""
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    t14 = time.perf_counter()
    need = ("min_reduce_w1", "score_pairs")
    for name in ("scale40k", "scale100k"):
        reads, _ = scale_input(bench, name, tmpdir)
        res = scale_run(bench, TorchOverlapper(), reads, name, kern, need,
                        0, 0)
        add(res["launches"], need)
        log(f"[14] {scale_summary(res)}")
        if name == "scale40k":
            fa = write_fasta(os.path.join(tmpdir, "scale40k.fa"), reads)
            reset_counters(kern)
            lines, secs = cli_in_process(["-s", fa])
            counts = read_counters(kern)
            check_scale(bench, name, lines)
            add(counts, need)
            log(f"[14] CLI -s scale40k.fa in process: {len(lines):,} lines "
                f"sha256-equal to native, {secs:.3f} s, launches {counts}")
            del lines
        del reads
    log(f"[14] phase 14 took {time.perf_counter() - t14:.1f} s")


def sharded_phase(bench, kern, add, launches, native_sha, run5, reads10k,
                  reads_f, fc, tmpdir: str) -> None:
    """Phase 11: ShardedOverlapper at world size 1 on NCCL against phase
    5's run; 2 and 4 gloo ranks sharing the card (their kernels built
    here already), their launches added to ``launches``; the CLI as a
    subprocess, and under torchrun when there are 2 or more cards."""
    import torch

    from mhap_tpu_torch.parallel import comm, launch
    from mhap_tpu_torch.parallel.jobs import run_jobs
    from mhap_tpu_torch.parallel.sharded import _INT_STATS, ShardedOverlapper

    t11 = time.perf_counter()
    # (a) one rank, NCCL, cuda:0: lognormal10k as phase 5 ran it
    with comm.single("nccl", "cuda:0") as c:
        ov = ShardedOverlapper(c)
        lines, counts, cold, steady, peak = run_main_path(ov, reads10k,
                                                          kern)
        stats = ov.total_stats()
    add(counts, ("min_reduce_w1", "score_pairs"))
    sha = bench.lineset_sha256(lines)
    same_stats = all(stats[k] == run5["stats"][k] for k in _INT_STATS)
    log(f"[11] (a) world size 1, NCCL: lognormal10k {len(lines)} lines, "
        f"sha256 equal to native's: {sha == native_sha['lognormal10k']}, "
        f"stats equal to phase 5's: {same_stats}, launches {counts}; cold "
        f"{cold:.3f} s, steady {steady:.3f} s (phase 5, single-GPU: cold "
        f"{run5['cold']:.3f} s, steady {run5['steady']:.3f} s), peak "
        f"{peak / 2**20:.1f} MiB (phase 5 {run5['peak'] / 2**20:.1f} MiB),"
        f" postings {ov.index_bytes / 2**20:.1f} MiB")
    if (len(lines) != EXPECTED_LOGNORMAL10K
            or sha != native_sha["lognormal10k"] or not same_stats):
        raise AssertionError("sharded world size 1 differs from phase 5")
    del ov
    # (b) D gloo ranks on cuda:0, staging collectives through the host
    primary = bench.make_reads()
    want = {"primary": (EXPECTED_PRIMARY, ("min_reduce_w1", "score_pairs")),
            "filtered2k": (EXPECTED_FILTERED2K,
                           ("weighted_min_reduce", "score_pairs"))}
    runs = {2: [("primary", dict(reads=primary)),
                ("filtered2k", dict(reads=reads_f, filter=fc))],
            4: [("primary", dict(reads=primary))]}
    postings = {}
    for D, jobs in runs.items():
        t0 = time.perf_counter()
        res = launch.run_ranks(run_jobs, D, backend="gloo",
                               devices=["cuda:0"] * D,
                               args=([job for _n, job in jobs],))
        secs = time.perf_counter() - t0
        for j, (name, _job) in enumerate(jobs):
            ranks = [r[j] for r in res]
            got = ranks[0]["lines"]
            counts = {k: sum(r["launches"][k] for r in ranks) for k in kern
                      if k in ranks[0]["launches"]}
            add(counts, want[name][1])
            ok = (len(got) == want[name][0] and not any(
                r["lines"] for r in ranks[1:]) and
                bench.lineset_sha256(got) == native_sha[name])
            postings.setdefault(name, {})[D] = [r["index_bytes"]
                                                for r in ranks]
            log(f"[11] (b) {D} gloo ranks on cuda:0, {name}: {len(got)} "
                f"lines, sha256 equal to native's: {ok}; by rank: launches "
                f"{[r['launches'] for r in ranks]}, peak "
                f"{[round(r['peak_bytes'] / 2**20, 1) for r in ranks]} MiB,"
                f" postings {[round(b / 2**20, 2) for b in postings[name][D]]}"
                f" MiB, wall {[round(r['seconds'], 3) for r in ranks]} s "
                f"(launch {secs:.1f} s, processes included)")
            if not ok:
                raise AssertionError(f"{D} ranks on {name} differ")
    by_d = {D: sum(b) for D, b in postings["primary"].items()}
    if len(set(by_d.values())) != 1 or any(
            len(set(b)) != 1 for b in postings["primary"].values()):
        raise AssertionError(f"postings are not split evenly: {postings}")
    # (c) the CLI, a subprocess at world size 1; torchrun with every card
    fa = write_fasta(os.path.join(tmpdir, "primary11.fa"), primary)
    cli_lines, cli_s = cli_process(["--backend", "sharded", "-s", fa])
    ok = bench.lineset_sha256(cli_lines) == native_sha["primary"]
    log(f"[11] (c) CLI --backend sharded -s primary.fa, world size 1: "
        f"{len(cli_lines)} lines, sha256 equal to native's: {ok} "
        f"({cli_s:.1f} s, process included)")
    if not ok:
        raise AssertionError("sharded CLI differs from native")
    n = torch.cuda.device_count()
    if n >= 2:
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             f"--nproc-per-node={n}", "-m", "mhap_tpu_torch.cli.main",
             "--backend", "sharded", "-s", fa], cwd=REPO,
            capture_output=True, text=True)
        tr_lines = sorted(r.stdout.splitlines())
        ok = (r.returncode == 0 and bench.lineset_sha256(tr_lines)
              == native_sha["primary"])
        log(f"[11] (c) torchrun --nproc-per-node {n}, NCCL: {len(tr_lines)}"
            f" lines, sha256 equal to native's: {ok} "
            f"({time.perf_counter() - t0:.1f} s)")
        if not ok:
            raise AssertionError(f"torchrun CLI differs: {r.stderr[-3000:]}")
    else:
        log(f"[11] (c) torchrun not run: {n} card (NCCL takes one card a "
            f"rank); scripts/sharded_check.py runs NCCL ranks on 2 or more")
    log(f"[11] phase 11 took {time.perf_counter() - t11:.1f} s")


def roc_phase(bench, kern, add, results, roc_inputs, tmpdir: str) -> None:
    """Phase 12: kernel 5's registers, spills and resident warps in both
    stat layouts; kernel 5 against its plain version on the adversarial
    set and the tie pairs; EstimateROC as bench_config_lognormal runs it
    on lognormal10k and on filtered2k, against the JAX package's goldens,
    the batched Smith-Waterman on the card; kernel 5 timed on filtered2k's
    disputed pairs, on the first 8 cut to 2,000 bases and on sw_long_pairs
    (the 32-bit stats); the tool's CLI as a subprocess."""
    import torch

    from mhap_tpu_torch.ops import swalign_kernels as swk
    from mhap_tpu_torch.ops.swalign import pack_pairs
    from mhap_tpu_torch.ops.swalign import sw_align_batch as sw_plain
    from mhap_tpu_torch.tools.estimate_roc import EstimateROC

    t12 = time.perf_counter()
    dev = torch.device("cuda")
    sw = swk.sw_align_batch
    rate = sm_rate(INT_ISSUE_PER_SM_CLOCK)
    log(f"[12] integer issue rate {rate / 1e12:.3f} T op/s")

    def cols(out):
        return [out[k] for k in SW_COLS]

    def check(name, args, reps=5):
        """Kernel vs plain on args, bit for bit; both timed (the plain
        version one run, the one compared)."""
        got = sw(*args)
        want = []
        plain_ms = once_ms(lambda: want.append(sw_plain(*args)))
        ql, rl = args[1].long(), args[3].long()
        cells = int((ql * rl).sum())
        t = dict(name=name, pairs=len(ql), cells=cells,
                 err=max_err(cols(got), cols(want[0])),
                 ms=time_ms(lambda: sw(*args), reps=reps),
                 plain_ms=plain_ms,
                 **bound(args[0].numel() + args[2].numel() + 40 * len(ql),
                         cells * SW_OPS_PER_CELL, rate))
        t["gcups"] = cells / t["ms"] / 1e6
        log(f"[12] kernel 5 on {name}: {t}")
        return t

    def to_card(pairs):
        return [torch.from_numpy(x).to(dev) for x in pack_pairs(pairs)]

    # what the card gives each instantiation of the kernel
    for wide in (False, True):
        occ = swk.occupancy(wide)
        log(f"[12] kernel 5, {('two-word', '32-bit')[wide]} stats: {occ}")
    # (a) the CPU test's adversarial set (lengths around the warp's
    # stripe of swk.STRIPE rows) and its tie-heavy short pairs
    timings = [check("the adversarial set",
                     to_card(sw_adversarial_pairs(B=swk.STRIPE)
                             + sw_tie_pairs()))]
    # (b) EstimateROC as bench_config_lognormal runs it, on the card; the
    # kernel's outputs on the disputed pairs are made again after the
    # launch counter is read
    reset_counters(kern)
    runs = {}
    for name, (reads, places, glen, lines) in roc_inputs.items():
        d = os.path.join(tmpdir, f"roc_{name}")
        os.makedirs(d, exist_ok=True)
        files = roc_files(bench, d, reads, places, glen, lines)
        runs[name] = estimate_roc_recorded(files)
        if name == "lognormal10k":
            ppv = runs[name][0].ppv
            # the per-pair path (native library) on the same stream
            per = EstimateROC(min_ovl_len=500, num_trials=2000, do_dp=True,
                              device="cuda")
            per.process_reference(files[0])
            per.load_fasta(files[2])
            per.process_overlaps(files[1])
            per.estimate_sensitivity()
            per.estimate_specificity()
            per.estimate_ppv(batch_dp=False)
            log(f"[12] (b) lognormal10k, batch_dp=False (per pair, native):"
                f" PPV {per.ppv} (batched {ppv})")
            # (c) the tool's entry point, per-pair DP as in JAX
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "mhap_tpu_torch.tools.estimate_roc",
                 *files, "500", "2000", "true"], cwd=REPO,
                capture_output=True, text=True)
            ok = (r.returncode == 0 and r.stdout.splitlines()
                  == ROC_GOLDENS[name]["cli"])
            log(f"[12] (c) python -m mhap_tpu_torch.tools.estimate_roc on "
                f"lognormal10k: {r.stdout.splitlines()}, equal to the JAX "
                f"tool's: {ok} ({time.perf_counter() - t0:.1f} s, process "
                f"included)")
            if not ok:
                raise AssertionError(f"estimate_roc CLI: {r.stderr[-2000:]}")
    counts = read_counters(kern)
    add(counts, ("sw_align_batch",))
    batches = {}
    for name, (roc, disputed, t_ppv, t_load) in runs.items():
        want = ROC_GOLDENS[name]
        got = dict(tp=roc.tp, fn=roc.fn, tn=roc.tn, fp=roc.fp,
                   sensitivity=roc.sensitivity(),
                   specificity=roc.specificity(), ppv=roc.ppv,
                   disputed=len(disputed), sw_sha256=None)
        extra = ""
        if disputed:
            args = batches[name] = roc.dp_batch_inputs(disputed)[0]
            got["sw_sha256"] = sw_sha256(sw(*args))
            ql, rl = (a.long() for a in args[1::2])
            extra = (f"; qlen x rlen: largest {int((ql * rl).max())}, sum "
                     f"{int((ql * rl).sum())}; [P, n], [P, m] "
                     f"{list(args[0].shape)}, {list(args[2].shape)}")
        ok = all(got[k] == want[k] for k in got)
        log(f"[12] (b) EstimateROC on {name} (batch_dp=True, cuda): {got}, "
            f"equal to the JAX goldens: {ok}; load, sensitivity and "
            f"specificity {t_load:.2f} s, PPV {t_ppv:.3f} s{extra}")
        if not ok:
            raise AssertionError(f"EstimateROC on {name}: {got} != {want}")
    log(f"[12] (b) launches {counts}; the JAX tool's per-pair PPV on "
        f"filtered2k: {ROC_GOLDENS['filtered2k']['cli'][2]!r}")
    # (a) kernel 5 at the main path's shape (filtered2k's disputed pairs)
    # and on its first 8 pairs cut to 2,000 bases
    args = batches["filtered2k"]
    main_t = check("filtered2k's disputed pairs", args, reps=3)
    cut = [args[0][:8, :2000].contiguous(), args[1][:8].clamp(max=2000),
           args[2][:8, :2000].contiguous(), args[3][:8].clamp(max=2000)]
    timings += [main_t, check("filtered2k's first 8 disputed pairs, cut to "
                              "2,000 bases", cut)]
    # (d) pairs past the two-word stats (a query past 65,535 bases): the
    # 32-bit instantiation, the plain version run once
    long_args = to_card(sw_long_pairs())
    n, m = long_args[0].shape[1], long_args[2].shape[1]
    if swk.packed_stats(n, m, 2, 1):
        raise AssertionError(f"the long pairs ({n} + {m}) take the "
                             f"two-word stats")
    timings.append(check(f"three pairs past the two-word stats ([P, n] x "
                         f"[P, m] = {n:,} x {m:,}; 32-bit stats)", long_args,
                         reps=1))
    got = sw(*long_args)
    log(f"[12] (d) the long pairs' q_begin {got['q_begin'].tolist()}, "
        f"q_end {got['q_end'].tolist()}")
    if int(got["q_end"][:2].min()) < 65_536:
        raise AssertionError("the long pairs' best rows stay inside 16 "
                             "bits")
    err = max(t["err"] for t in timings)
    results["sw_align_batch"] = dict(
        err=err, ms=main_t["ms"], plain_ms=main_t["plain_ms"],
        library_ms=None, bound_ms=main_t["bound_ms"],
        bound_by=main_t["bound_by"], timings=timings)
    log(f"[12] phase 12 took {time.perf_counter() - t12:.1f} s")
    if err:
        raise AssertionError(f"kernel 5 differs from its plain version: "
                             f"{timings}")


def np_xor_popcount(a, b, rows: int = 256):
    """numpy popcount(a[i] ^ b[j]) summed over the words, int64 [NA, NB],
    a block of rows at a time (np.bitwise_count: numpy 2.0 on)."""
    import numpy as np

    out = np.empty((len(a), len(b)), np.int64)
    for r in range(0, len(a), rows):
        x = a[r:r + rows, None, :] ^ b[None, :, :]
        out[r:r + rows] = np.bitwise_count(x).sum(-1, dtype=np.int64)
    return out


def unpacked_bits(x, dev):
    """[N, W] uint32 or uint64 words -> float16 [N, bits W] of their bits,
    0 or 1, on ``dev`` (the yardstick's operands)."""
    import numpy as np
    import torch

    by = torch.from_numpy(np.ascontiguousarray(x).view(np.uint8)).to(dev)
    shifts = torch.arange(8, device=dev, dtype=torch.uint8)
    return ((by[..., None] >> shifts) & 1).reshape(len(x), -1).half()


def kernel6_checks(kern, add, results, reads) -> None:
    """Phase 13 (a): kernel 6 against its plain version on the
    adversarial set, on the 1-bit MinHash sketches of the primary reads'
    main-path sketches (all against all, uint64 words and their uint32
    view) and on [8,192, 8] uint64 words of BITS_SEED, each timed with its
    bound, through the wrapper and as the card's time alone (device_ms),
    with an fp16 matmul of the unpacked bits as the product's yardstick;
    then ragged sets, rows past the kernel's output table and a set past
    the parent design's grid limit; the uint64 counts against a numpy
    popcount."""
    import numpy as np
    import torch

    from mhap_tpu_torch.ops.bits import bit_similarity_ref, words
    from mhap_tpu_torch.ops.bits_kernels import bit_similarity, occupancy
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper
    from mhap_tpu_torch.sketches.bits import (bit_similarity_matrix,
                                              pack_last_bits_msb_first)

    dev = torch.device("cuda")
    rate = sm_rate(TC_B1_OPS_PER_SM_CLOCK)
    popc_rate = sm_rate(POPC_PER_SM_CLOCK)
    occ = {f"vec={v}, table={tb}": occupancy(v, tb)
           for v in (True, False) for tb in (True, False)}
    log(f"[13] b1 tensor-core rate {rate / 1e12:.3f} T bit-op/s, "
        f"popcount rate {popc_rate / 1e12:.3f} T/s; kernel 6 occupancy {occ}")

    def same(got, want):
        return bool(torch.equal(got.view(torch.int32),
                                want.view(torch.int32)))

    def counts_ok(a, b, got):
        """uint64 words: round((1 - out) * 64W) is numpy's popcount."""
        if a.dtype != np.uint64:
            return True
        c = np.rint((1.0 - got.cpu().double().numpy()) * 64 * a.shape[1])
        return bool((c.astype(np.int64) == np_xor_popcount(a, b)).all())

    # the CPU test's adversarial set
    bad = []
    cases = bits_adversarial()
    for i, (a, b) in enumerate(cases):
        ka, kb = words(a, dev), words(b, dev)
        got = bit_similarity(ka, kb)
        if not (same(got, bit_similarity_ref(ka, kb))
                and counts_ok(a, b, got)):
            bad.append((i, a.dtype.name, a.shape, b.shape))
    log(f"[13] (a) kernel 6 on the adversarial set ({len(cases)} pairs): "
        f"{bad or 'bit-equal to plain, uint64 counts equal to numpy'}")

    def check(name, a, b, reps=5, yardstick=False):
        ka, kb = words(a, dev), words(b, dev)
        got = bit_similarity(ka, kb)
        bits = 8 * a.dtype.itemsize
        na, nb, w = len(a), len(b), a.shape[1]
        nbytes = 4 * na * nb + (na + nb) * w * bits // 8
        t = dict(name=name, shape=[na, nb, w], word_bits=bits,
                 equal=same(got, bit_similarity_ref(ka, kb)),
                 counts_equal=counts_ok(a, b, got),
                 ms=time_ms(lambda: bit_similarity(ka, kb), reps=reps),
                 device_ms=device_ms(lambda: bit_similarity(ka, kb),
                                     reps=reps),
                 plain_ms=once_ms(lambda: bit_similarity_ref(ka, kb)),
                 **bound(nbytes, 2 * na * nb * w * bits, rate))
        del got
        popc = bound(nbytes, na * nb * w * bits // 32, popc_rate)
        t.update(ratio=t["ms"] / t["bound_ms"],
                 device_ratio=t["device_ms"] / t["bound_ms"],
                 popc_bound_ms=popc["bound_ms"],
                 popc_ratio=t["ms"] / popc["bound_ms"])
        if yardstick:
            # the product alone: fp16 [NA, K] x [K, NB] of 0/1 values
            # (exact for K <= 2,048), unpacking left out; not used
            ua, ub = unpacked_bits(a, dev), unpacked_bits(b, dev)
            t["library_ms"] = time_ms(lambda: torch.matmul(ua, ub.T),
                                      reps=reps)
            t["library"] = "fp16 torch.matmul of the unpacked bits"
            del ua, ub
        t["err"] = 0 if t["equal"] and t["counts_equal"] else 1
        log(f"[13] (a) kernel 6 on {name}: {t}")
        return t

    # the main path: the primary reads' sketches, packed as
    # MinHashBitSketch packs them, compared all against all
    reset_counters(kern)
    ov = TorchOverlapper(device="cuda")
    store = ov.sketch_reads(reads)
    mh = store.host("minhash")[store.header_id != 0]
    bits64 = pack_last_bits_msb_first(mh)
    bits32 = bits64.view(np.uint32)
    sim64 = bit_similarity_matrix(bits64, bits64)
    sim32 = bit_similarity_matrix(bits32, bits32)
    torch.cuda.synchronize()
    counts = read_counters(kern)
    add(counts, ("min_reduce_w1", "bit_similarity_matrix"))
    n = len(mh)
    off = float(sim64.sum() - sim64.diagonal().sum()) / (n * n - n)
    same64 = bool(torch.equal(sim64, sim32))
    del sim64, sim32
    log(f"[13] (a) main path: sketch_reads of {len(reads)} primary reads, "
        f"{list(mh.shape)} MinHash -> {list(bits64.shape)} uint64 bit "
        f"sketches, bit_similarity_matrix on uint64 and uint32 words: "
        f"launches {counts}; uint64 and uint32 equal: {same64}; mean "
        f"off-diagonal similarity {off:.4f}")
    timings = [check(f"the primary reads' 1-bit sketches "
                     f"{list(bits64.shape)} uint64", bits64, bits64,
                     yardstick=True),
               check(f"the same as uint32 {list(bits32.shape)}", bits32,
                     bits32)]
    rng = np.random.default_rng(BITS_SEED)

    def rand(n, w, dt):
        return rng.integers(0, np.iinfo(dt).max, (n, w), dtype=dt,
                            endpoint=True)

    big = rand(2 * 8192, 8, np.uint64)
    timings.append(check("[8,192, 8] x [8,192, 8] uint64 words of a seed",
                         big[:8192], big[8192:], yardstick=True))
    del big
    for name, a, b in (
            ("ragged [2,047, 8] x [129, 8] uint64", rand(2047, 8, np.uint64),
             rand(129, 8, np.uint64)),
            ("ragged [2,047, 17] x [129, 17] uint32",
             rand(2047, 17, np.uint32), rand(129, 17, np.uint32)),
            ("rows past the output table, [130, 129] x [65, 129] uint64",
             rand(130, 129, np.uint64), rand(65, 129, np.uint64)),
            ("rows past the output table, unaligned, [2,048, 257] x "
             "[130, 257] uint32", rand(2048, 257, np.uint32),
             rand(130, 257, np.uint32)),
            ("past the parent design's grid limit, [4,200,000, 8] x [3, 8] "
             "uint64", rand(4_200_000, 8, np.uint64), rand(3, 8, np.uint64))):
        timings.append(check(name, a, b, reps=3))
    err = int(bool(bad)) + sum(t["err"] for t in timings) + (not same64)
    main_t = timings[0]
    results["bit_similarity_matrix"] = dict(
        err=err, ms=main_t["ms"], plain_ms=main_t["plain_ms"],
        library_ms=main_t["library_ms"], bound_ms=main_t["bound_ms"],
        bound_by=main_t["bound_by"], occupancy=occ, timings=timings)
    if err:
        raise AssertionError(f"kernel 6 differs: {bad}, {timings}")


def bits_phase(bench, kern, add, results, reads, tmpdir: str) -> None:
    """Phase 13: kernel6_checks, with ``--backend oracle`` through the
    CLI on the first ORACLE_READS reads as a subprocess beside it (host
    numpy for ~20 s), then its line set against the device CLI's and the
    native binary's on the same file."""
    t13 = time.perf_counter()
    sub = reads[:ORACLE_READS]
    fa = write_fasta(os.path.join(tmpdir, "oracle.fa"), sub)
    oracle = subprocess.Popen(
        [sys.executable, "-m", "mhap_tpu_torch.cli.main", "-s", fa,
         "--backend", "oracle"], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        kernel6_checks(kern, add, results, reads)
        d_lines, d_secs = cli_process(["-s", fa])
        out, errs = oracle.communicate()
    finally:
        if oracle.poll() is None:
            oracle.kill()
            oracle.communicate()
    if oracle.returncode != 0:
        raise AssertionError(f"--backend oracle exited {oracle.returncode}:"
                             f" {errs[-3000:]}")
    o_lines = sorted(out.splitlines())
    o_secs = [l for l in errs.splitlines() if l.startswith("Total time")]
    _, n_nat, threads, nat_sha, nat_t = bench.bench_native(sub)
    o_sha, d_sha = (bench.lineset_sha256(x) for x in (o_lines, d_lines))
    log(f"[13] (b) --backend oracle on {len(sub)} primary reads: "
        f"{len(o_lines)} lines, sha256 {o_sha[:16]}, {o_secs} (its own "
        f"clock, beside (a)); device CLI {len(d_lines)} lines, sha256 "
        f"{d_sha[:16]}, {d_secs:.1f} s (process included); native {n_nat} "
        f"lines, sha256 {nat_sha[:16]}, {nat_t} s on {threads} threads")
    if not o_lines or not o_sha == d_sha == nat_sha:
        raise AssertionError("--backend oracle differs from the device CLI "
                             "or native")
    log(f"[13] phase 13 took {time.perf_counter() - t13:.1f} s")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "mhap_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(mhap_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import bench
    from mhap_tpu_torch.cli.options import PRESETS
    from mhap_tpu_torch.ops import _build
    from mhap_tpu_torch.ops.bits_kernels import bit_similarity
    from mhap_tpu_torch.ops import merge as mg
    from mhap_tpu_torch.ops import minhash as mh
    from mhap_tpu_torch.ops import murmur3
    from mhap_tpu_torch.ops.merge_kernels import merge2
    from mhap_tpu_torch.ops.minhash_kernels import (HEAVY_MIN, heavy_kmers,
                                                    light_segments,
                                                    min_reduce_w1,
                                                    weighted_min_reduce)
    from mhap_tpu_torch.ops.minhash_kernels import plan as minhash_plan
    from mhap_tpu_torch.ops.scorer import COLS, score_pairs_ref
    from mhap_tpu_torch.ops.scorer_kernels import occupancy, score_pairs
    from mhap_tpu_torch.ops.scorer_kernels import plan as scorer_plan
    from mhap_tpu_torch.ops.swalign_kernels import sw_align_batch
    from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
    from mhap_tpu_torch.pipeline.overlapper import (TorchOverlapper,
                                                    _rc_codes,
                                                    jaccard_to_identity)

    dev = torch.device("cuda")
    kern = {"min_reduce_w1": min_reduce_w1,
            "weighted_min_reduce": weighted_min_reduce,
            "score_pairs": score_pairs, "merge2": merge2,
            "sw_align_batch": sw_align_batch,
            "bit_similarity_matrix": bit_similarity}
    path_kernels = ("min_reduce_w1", "weighted_min_reduce", "score_pairs",
                    "sw_align_batch", "bit_similarity_matrix")
    tmp = tempfile.TemporaryDirectory()
    # ---- phase 1: card, versions, build ----
    smi = nvidia_smi()
    rate = sm_rate(INT32_LANES_PER_SM)
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}; INT32 "
        f"rate {rate / 1e12:.3f} T op/s")
    t0 = time.perf_counter()
    _build.kernels()
    log(f"[1] kernels built+loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds} s) -> {_build.library_path()}")

    # ---- phase 2: kernels vs plain at the main path's shapes ----
    results = {}
    reads = bench.make_reads()
    k1, H, S = 16, 512, 1536
    codes = np.frombuffer("".join(reads[:512]).encode(), np.uint8)
    seq = torch.from_numpy(codes.reshape(512, -1).copy()).to(dev)
    h = murmur3.kmer_hashes_128(seq, k1)
    act = torch.ones_like(h, dtype=torch.bool)
    err1 = max_err([min_reduce_w1(h, act, H)],
                   [mh.min_reduce_w1_ref(h, act, H)])
    # random masks, one empty row, one row past a register tile
    g1 = torch.Generator(device=dev).manual_seed(11)
    hr = torch.randint(-2**63, 2**63 - 1, (6, 9000), device=dev,
                       dtype=torch.int64, generator=g1)
    ar = torch.rand((6, 9000), device=dev, generator=g1) < 0.7
    ar[2] = False
    ar[3, 5000:] = False
    errx = max_err([min_reduce_w1(hr, ar, H)],
                   [mh.min_reduce_w1_ref(hr, ar, H)])
    log(f"[2] kernel 1 on random rows [6, 9000] (empty row, masks): "
        f"max|err| {errx}")
    B, n = h.shape
    results["min_reduce_w1"] = dict(
        err=max(err1, errx), ms=time_ms(lambda: min_reduce_w1(h, act, H)),
        plain_ms=time_ms(lambda: mh.min_reduce_w1_ref(h, act, H)),
        library_ms=None, **bound(B * n * 9 + B * H * 4,
                                 int(act.sum()) * H * OPS_PER_STREAM_STEP,
                                 rate))
    log(f"[2] kernel 1 min_reduce_w1 {tuple(h.shape)} H={H}: "
        f"{results['min_reduce_w1']}")

    # weights 1..4 (a 100 bp segment repeated up to 4 times) + one tandem
    # row with weights around 200
    h2, v2 = code_rows(repeat_rows(reads), k1, dev)
    args2 = weighted_inputs(h2, v2)
    w2 = args2[1]
    err2 = max_err([weighted_min_reduce(*args2, H)],
                   [mh.weighted_min_reduce_ref(*args2, H)])
    t2 = k2_timing("phase 2 rows", args2, H, rate)
    k2 = results["weighted_min_reduce"] = dict(
        err=err2, ms=t2["ms"], plain_ms=time_ms(
            lambda: mh.weighted_min_reduce_ref(*args2, H), reps=3),
        library_ms=None, bound_ms=t2["bound_ms"], bound_by=t2["bound_by"],
        timings=[t2])
    log(f"[2] kernel 2 weighted_min_reduce {tuple(h2.shape)}, max weight "
        f"{int(w2.max())}: {k2}")
    # kernel 2's three passes on inputs aimed at them: each bit-equal to
    # the plain version (at w = 30,000 to the kernel's light pass alone)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sweep_err = 0
    for name, (args, Hd) in design_rows(dev, HEAVY_MIN).items():
        got = weighted_min_reduce(*args, Hd)
        if name == "w30000":
            alone = dict(heavy_min=int(args[1].max()) + 1)
            e = max_err([got], [weighted_min_reduce(*args, Hd, **alone)])
            k2["timings"].append(k2_timing(f"{name}, light pass alone",
                                           args, Hd, rate, reps=3, **alone))
        else:
            e = max_err([got], [mh.weighted_min_reduce_ref(*args, Hd)])
        if name == "long":  # its heavy k-mers in slabs of 100
            e = max(e, max_err([weighted_min_reduce(*args, Hd, slab=100)],
                               [got]))
        k2["err"] = max(k2["err"], e)
        k2["timings"].append(k2_timing(name, args, Hd, rate))
        seg, nseg = light_segments(*args[0].shape, sms)
        log(f"[2] kernel 2 on {name} {tuple(args[0].shape)} H={Hd}: "
            f"max|err| {e}; {nseg} segments of {seg}, "
            f"{len(heavy_kmers(args[1], args[2]))} heavy k-mers; "
            f"{k2['timings'][-1]}")
    sw, e = k2_sweep(args2, H, "heavy_min", HEAVY_MIN_GRID)
    sweep_err += e
    log(f"[2] kernel 2 on the phase 2 rows by heavy_min (ms): {sw}; "
        f"max|diff| {e}")

    # filtered2k: kernel 2 at tf-idf weights, device vs host weights
    reads_f, filter_path = filtered2k(bench, tmp.name)
    fc = read_filter(filter_path)
    bad_w, err2f = check_filtered(reads_f, filter_path, fc, k1, H, dev)
    k2["err"] = max(k2["err"], err2f)

    ov = TorchOverlapper(device="cuda")
    store, qg, cand = candidate_pairs(ov, reads)
    log(f"[2] primary workload: {len(qg)} candidate pairs")
    qi = torch.from_numpy(qg[:4096].astype(np.int32)).to(dev)
    ci = torch.from_numpy(cand[:4096].astype(np.int32)).to(dev)
    cols = store.scorer_cols()
    got = score_pairs(cols, cols, qi, ci, 0.2)
    ql, cl = qi.long(), ci.long()
    gathered = [c[ql] for c in cols] + [c[cl] for c in cols]
    want = score_pairs_ref(*gathered, 0.2)
    err3 = max_err([got], [want])
    T = len(qi)
    t3 = k3_timing(f"primary: first {T} candidate pairs", cols, cols, qi,
                   ci, rate)
    results["score_pairs"] = dict(
        err=err3, ms=t3["ms"],
        plain_ms=time_ms(lambda: score_pairs_ref(*gathered, 0.2)),
        library_ms=None, bound_ms=t3["bound_ms"], bound_by=t3["bound_by"],
        timings=[t3])
    log(f"[2] kernel 3 at S={S}: {occupancy(S)}; bound on {T} pairs: "
        f"{t3['row_bytes']} bytes of distinct rows, {t3['cursor_steps']} "
        f"cursor steps")
    # the native C++ automaton on the same pairs
    fn = native_scorer()
    host = [store.host(n) for n in ("ordered_h", "ordered_p", "ordered_m",
                                    "num_kmers")]
    g3 = got.cpu().numpy()
    nat_bad = native_check(fn, host, host, qg[:4096], cand[:4096], g3,
                           jaccard_to_identity)
    log(f"[2] kernel 3 score_pairs {T} pairs: max|err| {err3} vs plain, "
        f"{nat_bad} lanes differ from native, ok lanes "
        f"{int(g3[:, 0].sum())}, escal {int(g3[:, COLS.index('escal')].sum())}"
        f"; {results['score_pairs']}")
    # adversarial pairs at S = 1536: deep duplicate runs
    adv = adversarial_pairs(256, S, seed=bench.SEED)
    qa = [torch.from_numpy(x).to(dev) for x in adv[0]]
    ca = [torch.from_numpy(x).to(dev) for x in adv[1]]
    idx = torch.arange(256, device=dev, dtype=torch.int32)
    got_a = score_pairs(qa, ca, idx, idx, 0.2)
    err_a = max_err([got_a], [score_pairs_ref(*qa, *ca, 0.2)])
    ga = got_a.cpu().numpy()
    nat_a = native_check(fn, adv[0], adv[1], range(256), range(256), ga,
                         jaccard_to_identity)
    log(f"[2] kernel 3 on 256 adversarial pairs: max|err| {err_a} vs "
        f"plain, {nat_a} lanes differ from native, ok lanes "
        f"{int(ga[:, 0].sum())}, mean shared entries "
        f"{ga[:, COLS.index('n_shared')].mean():.0f}")
    results["score_pairs"]["timings"].append(
        k3_timing("256 adversarial pairs", qa, ca, idx, idx, rate))
    # pairs aimed at the kernel's decomposition: runs of S equal hashes,
    # S shared distinct hashes, none shared, positions repeated across
    # hashes
    dq, dc, kinds = scorer_design_pairs(S, seed=bench.SEED + 5)
    qd = [torch.from_numpy(x).to(dev) for x in dq]
    cd = [torch.from_numpy(x).to(dev) for x in dc]
    idx = torch.arange(len(kinds), device=dev, dtype=torch.int32)
    got_d = score_pairs(qd, cd, idx, idx, 0.2)
    err_d = max_err([got_d], [score_pairs_ref(*qd, *cd, 0.2)])
    gd = got_d.cpu().numpy()
    nat_d = native_check(fn, dq, dc, range(len(kinds)), range(len(kinds)),
                         gd, jaccard_to_identity)
    for kind in dict.fromkeys(kinds):
        sel = torch.tensor([i for i, k in enumerate(kinds) if k == kind],
                           device=dev, dtype=torch.int32)
        results["score_pairs"]["timings"].append(
            k3_timing(f"design: {kind}", qd, cd, sel, sel, rate))
    log(f"[2] kernel 3 on {len(kinds)} design pairs ({', '.join(kinds[::4])}"
        f", 4 each): max|err| {err_d} vs plain, {nat_d} lanes differ from "
        f"native, ok lanes {int(gd[:, 0].sum())}, escal "
        f"{int(gd[:, COLS.index('escal')].sum())}, pass-1 records "
        f"{gd[:, COLS.index('cnt1')].tolist()}; "
        f"{results['score_pairs']['timings'][-4:]}")
    results["score_pairs"]["err"] = max(err3, err_a, err_d)
    nat_bad += nat_a + nat_d

    # kernel 4: the primary pairs' ordered sketches, adversarial rows, and
    # the same sketches cut to S - 1 = 1,535 columns (rows not 16-byte
    # aligned: the cp.async path)
    ma = merge_rows(store, qi) + merge_rows(store, ci)
    OW = 2 * S
    merge2.launches = 0
    err4 = max_err(merge2(*ma, out_width=OW), mg.merge2_ref(*ma, OW))
    (xa0, xa1), (xb0, xb1) = adversarial_merge_rows(37, S, bench.SEED)
    xa = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
          for x in (xa0, xa1, xb0, xb1)]
    err4x = max_err(merge2(*xa), mg.merge2_ref(*xa))
    mu = [x[:, :S - 1].contiguous() for x in ma]
    err4u = max_err(merge2(*mu), mg.merge2_ref(*mu))
    merge_launches = merge2.launches
    log(f"[2] kernel 4 merge2 on 37 adversarial row pairs at S={S}: "
        f"max|err| {err4x}; on the primary rows cut to S={S - 1}: max|err| "
        f"{err4u}")
    t4 = k4_timing(f"primary: first {T} candidate pairs", ma, OW, rate)
    t4u = k4_timing(f"primary: first {T} pairs, S={S - 1}", mu,
                    2 * (S - 1), rate)
    results["merge2"] = dict(
        err=max(err4, err4x, err4u, t4["err"], t4u["err"]), ms=t4["ms"],
        plain_ms=t4["plain_ms"], library_ms=t4["library_ms"],
        bound_ms=t4["bound_ms"], bound_by=t4["bound_by"], timings=[t4, t4u])
    log(f"[2] kernel 4 merge2 [{T}, {S}] -> [{T}, {OW}] on primary pair "
        f"sketches: {t4}; cut to S={S - 1}: {t4u}")
    failures = [n for n, r in results.items() if r["err"] != 0]
    if sweep_err:
        failures.append("weighted_min_reduce across plan parameters")
    if nat_bad:
        failures.append("score_pairs vs native")
    if bad_w:
        failures.append("filter weights device vs host")
    if failures:
        raise AssertionError(f"kernels disagree: {failures}")

    # phase 2's tensors go before the main-path runs read peak memory
    del h, act, hr, ar, h2, v2, args2, w2, args, store, cols, got, want
    del gathered, qa, ca, got_a, ma, xa, mu, qd, cd, got_d
    launches = dict.fromkeys(kern, 0)

    def add(counts, need):
        for k, v in counts.items():
            launches[k] += v
        missing = [k for k in need if counts[k] == 0]
        if missing:
            raise AssertionError(f"the path skipped {missing}: {counts}")

    def mib(b):
        return f"{b / 2**20:.1f} MiB"

    # ---- phase 3: primary workload ----
    _, n_nat, threads, nat_sha, nat_t = bench.bench_native(reads)
    ov = TorchOverlapper(device="cuda")
    lines, counts, cold, steady, peak = run_main_path(ov, reads, kern)
    add(counts, ("min_reduce_w1", "score_pairs"))
    sha = bench.lineset_sha256(lines)
    log(f"[3] primary: {len(lines)} lines (native {n_nat}), sha256 "
        f"{sha[:16]} native {nat_sha[:16]}, launches {counts}; cold "
        f"{cold:.3f} s, steady {steady:.3f} s, peak {mib(peak)}; native "
        f"{nat_t} s on {threads} threads")
    if len(lines) != EXPECTED_PRIMARY or sha != nat_sha:
        raise AssertionError("primary workload line set differs")
    native_sha = {"primary": nat_sha}
    # the CLI's presets in this process, against native at the flags each
    # expands to
    fa3 = write_fasta(os.path.join(tmp.name, "primary3.fa"), reads)
    for st in (2, 3):
        flags = [str(x) for kv in PRESETS[st].items() for x in kv]
        _, n_nat, threads, nat_sha, nat_t = bench.bench_native(
            reads, extra=flags)
        reset_counters(kern)
        lines, secs = cli_in_process(["-s", fa3, "--settings", st])
        counts = read_counters(kern)
        add(counts, ("min_reduce_w1", "score_pairs"))
        sha = bench.lineset_sha256(lines)
        log(f"[3] CLI -s primary.fa --settings {st} ({' '.join(flags)}): "
            f"{len(lines)} lines (native {n_nat}), sha256 {sha[:16]} native "
            f"{nat_sha[:16]}, launches {counts}, {secs:.2f} s in process; "
            f"native {nat_t} s on {threads} threads")
        if sha != nat_sha or not lines:
            raise AssertionError(f"CLI --settings {st} differs from native")

    # ---- phase 4: repeat mix ----
    mix = repeat_mix(bench)
    _, n_nat, _, nat_sha, _ = bench.bench_native(mix)
    ov = TorchOverlapper(device="cuda")
    lines, counts, cold, steady, peak = run_main_path(ov, mix, kern)
    add(counts, ("weighted_min_reduce", "score_pairs"))
    sha = bench.lineset_sha256(lines)
    # kernel 2 on the mix's repeat rows, by heavy_min
    strands = []
    for r in mix:
        c = np.frombuffer(r.encode(), np.uint8)
        strands += [c, _rc_codes(c)]
    hm4, vm4 = code_rows(strands, k1, dev)
    dup = mh.dup_rows(hm4, vm4)
    sw, e = k2_sweep(weighted_inputs(hm4[dup], vm4[dup]), H, "heavy_min",
                     HEAVY_MIN_GRID)
    sweep_err += e
    log(f"[4] repeat mix: {len(lines)} lines (native {n_nat}), sha256 "
        f"{sha[:16]} native {nat_sha[:16]}, launches {counts}; cold "
        f"{cold:.3f} s, steady {steady:.3f} s, peak {mib(peak)}; kernel 2 "
        f"on its {int(dup.sum())} repeat strands by heavy_min (ms): {sw}, "
        f"max|diff| {e}")
    del hm4, vm4
    if sha != nat_sha or sweep_err:
        raise AssertionError("repeat mix line set or kernel 2 differs")

    # ---- phase 5: lognormal10k ----
    reads10k, places10k, glen10k = bench.make_reads_placed(
        10_000, seed=bench.SEED + 1)
    _, n_nat, threads, nat_sha, nat_t = bench.bench_native(reads10k)
    ov = TorchOverlapper(device="cuda")
    lines, counts, cold, steady, peak = run_main_path(ov, reads10k, kern)
    add(counts, ("min_reduce_w1", "score_pairs"))
    sha = bench.lineset_sha256(lines)
    native_sha["lognormal10k"] = nat_sha
    run5 = dict(stats=dict(ov.stats), cold=cold, steady=steady, peak=peak)
    roc_inputs = {"lognormal10k": (reads10k, places10k, glen10k, lines)}
    log(f"[5] lognormal10k: {len(lines)} lines (native {n_nat}), sha256 "
        f"{sha} native {nat_sha}, launches {counts}; cold {cold:.3f} s, "
        f"steady {steady:.3f} s, peak {mib(peak)}; native {nat_t} s on "
        f"{threads} threads; stats {ov.stats}")
    st5, qg5, cand5 = pairs5 = candidate_pairs(ov, reads10k)
    e5, t5 = k3_run_pairs("lognormal10k", pairs5, rate)
    results["score_pairs"]["timings"].append(t5)
    log(f"[5] kernel 3 on lognormal10k's candidate pairs: {t5}; max|err| "
        f"vs plain on the first 4,096: {e5}")
    # kernel 4 at a steady shape: the first 32,768 candidate pairs' ordered
    # sketches, [32,768, 1,536] -> [32,768, 3,072]
    qi5 = torch.from_numpy(qg5[:32768].astype(np.int32)).to(dev)
    ci5 = torch.from_numpy(cand5[:32768].astype(np.int32)).to(dev)
    m5 = merge_rows(st5, qi5) + merge_rows(st5, ci5)
    t4s = k4_timing(f"lognormal10k: first {len(qi5)} of {len(qg5)} "
                    f"candidate pairs", m5, 2 * S, rate, plain=False)
    results["merge2"]["timings"].append(t4s)
    results["merge2"]["err"] = max(results["merge2"]["err"], t4s["err"])
    log(f"[5] kernel 4 on lognormal10k's first {len(qi5)} pairs: {t4s}")
    del st5, pairs5, m5
    if (len(lines) != EXPECTED_LOGNORMAL10K or sha != nat_sha or e5
            or t4s["err"] or len(qi5) != 32768):
        raise AssertionError("lognormal10k line set, kernel 3 or kernel 4 "
                             "differs")

    # ---- phase 6: filtered2k ----
    _, n_nat, threads, nat_sha, nat_t = bench.bench_native(
        reads_f, extra=("-f", filter_path))
    ov = TorchOverlapper(device="cuda", kmer_filter=VectorFrequencyFilter(
        fc, "cuda"))
    chunks = []
    sketch_chunk = ov._sketch_chunk

    def first_chunk(codes, lens):
        if not chunks:
            chunks.append((codes, lens))
        return sketch_chunk(codes, lens)

    ov._sketch_chunk = first_chunk
    lines, counts, cold, steady, peak = run_main_path(ov, reads_f, kern)
    add(counts, ("weighted_min_reduce", "score_pairs"))
    # kernel 2 on the run's first chunk, as _sketch_chunk builds it
    codes, lens = chunks[0]
    hc = murmur3.kmer_hashes_128(torch.from_numpy(codes).to(dev), k1)
    vc = (torch.arange(hc.shape[1], device=dev)[None]
          < torch.from_numpy(lens - k1 + 1).to(dev)[:, None])
    args6 = weighted_inputs(hc, vc, ov._weights)
    alone = dict(heavy_min=int(args6[1].max()) + 1)
    e6 = max_err([weighted_min_reduce(*args6, H)],
                 [weighted_min_reduce(*args6, H, **alone)])
    k2["err"] = max(k2["err"], e6)
    k2["timings"].append(k2_timing("filtered2k chunk", args6, H, rate))
    sw, e = k2_sweep(args6, H, "heavy_min", HEAVY_MIN_GRID)
    sweep_err += e
    log(f"[6] kernel 2 on the first filtered2k chunk {tuple(hc.shape)} "
        f"(max weight {alone['heavy_min'] - 1}; "
        f"{light_segments(*hc.shape, sms)[1]} segments, "
        f"{len(heavy_kmers(args6[1], args6[2]))} heavy k-mers): "
        f"{k2['timings'][-1]}; max|err| "
        f"vs its light pass alone {e6}; by heavy_min (ms): {sw}, "
        f"max|diff| {e}")
    del hc, vc, args6
    e6, t6 = k3_run_pairs("filtered2k", candidate_pairs(ov, reads_f), rate)
    results["score_pairs"]["timings"].append(t6)
    log(f"[6] kernel 3 on filtered2k's candidate pairs: {t6}; max|err| "
        f"vs plain on the first 4,096: {e6}")
    results["score_pairs"]["err"] = max(results["score_pairs"]["err"], e6)
    sha = bench.lineset_sha256(lines)
    fa = os.path.join(tmp.name, "reads_f.fa")
    with open(fa, "w") as f:
        f.writelines(f">r{i}\n{r}\n" for i, r in enumerate(reads_f))
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "mhap_tpu_torch.cli.main",
                          "-s", fa, "-f", filter_path], cwd=REPO,
                         capture_output=True, text=True, check=True)
    cli_s = time.perf_counter() - t0
    cli_lines = sorted(cli.stdout.splitlines())
    _, places_f, glen_f, _ = filtered2k_placed(bench)
    roc_inputs["filtered2k"] = (reads_f, places_f, glen_f, lines)
    log(f"[6] filtered2k: {len(lines)} lines (native -f {n_nat}), sha256 "
        f"{sha} native {nat_sha}, launches {counts}; cold {cold:.3f} s, "
        f"steady {steady:.3f} s, peak {mib(peak)}; native {nat_t} s on "
        f"{threads} threads; CLI -f: {len(cli_lines)} lines, equal to the "
        f"library's: {cli_lines == lines} ({cli_s:.1f} s, process "
        f"included)")
    if (len(lines) != EXPECTED_FILTERED2K or sha != nat_sha
            or cli_lines != lines or k2["err"] or sweep_err or e6):
        raise AssertionError("filtered2k line set or kernel 2 or 3 differs")
    native_sha["filtered2k"] = nat_sha

    # ---- phase 7: ultra-long mix ----
    reads_u = ultra_long_mix(bench)
    _, n_nat, threads, nat_sha, nat_t = bench.bench_native(reads_u)
    ov = TorchOverlapper(device="cuda")
    lines, counts, cold, steady, peak = run_main_path(ov, reads_u, kern)
    add(counts, ("min_reduce_w1", "weighted_min_reduce", "score_pairs"))
    sha = bench.lineset_sha256(lines)
    long_hid = set(range(1, 17))
    long_lines = sum(1 for line in lines
                     if {int(x) for x in line.split()[:2]} & long_hid)
    # kernel 2 on the chunk of the 32 long strands, as _sketch_chunk
    # builds it
    strands = []
    for r in reads_u[:16]:
        c = np.frombuffer(r.encode(), np.uint8)
        strands += [c, _rc_codes(c)]
    strands.sort(key=len)
    hl, vl = code_rows(strands, k1, dev)
    args7 = weighted_inputs(hl, vl)
    k2_long = k2_timing("ultra-long chunk", args7, H, rate)
    k2["timings"].append(k2_long)
    seg, nseg = light_segments(*hl.shape, sms)
    log(f"[7] ultra-long mix: {len(reads_u)} reads (16 of "
        f"{min(map(len, reads_u[:16]))}-{max(map(len, reads_u[:16]))} bp), "
        f"{len(lines)} lines ({long_lines} with a long read; native "
        f"{n_nat}), sha256 {sha} native {nat_sha}, launches {counts}; cold "
        f"{cold:.3f} s, steady {steady:.3f} s, peak {mib(peak)}; native "
        f"{nat_t} s on {threads} threads; kernel 2 on the 32 long strands "
        f"{tuple(hl.shape)}: {k2_long['ms']:.3f} ms, bound "
        f"{k2_long['bound_ms']:.3f} ms ({k2_long['bound_by']}); light pass "
        f"{len(strands) * nseg} blocks ({nseg} segments of {seg} k-mers a "
        f"strand) on {sms} SMs, {len(heavy_kmers(args7[1], args7[2]))} "
        f"heavy k-mers")
    del hl, vl, args7
    if sha != nat_sha or long_lines == 0:
        raise AssertionError("ultra-long mix line set differs")

    # ---- phase 8: long strands past the CELLS budget ----
    reads_s = ultra_long_mix(bench, seed=4245, genome_len=2_000_000,
                             lens=list(range(380_000, 404_000, 1_000)))
    _, n_nat, threads, nat_sha, nat_t = bench.bench_native(reads_s)
    ov = TorchOverlapper(device="cuda")
    chunks = []
    sketch_chunk = ov._sketch_chunk

    def recorded(codes, lens):
        chunks.append(codes.shape)
        return sketch_chunk(codes, lens)

    ov._sketch_chunk = recorded
    lines, counts, cold, steady, peak = run_main_path(ov, reads_s, kern)
    add(counts, ("weighted_min_reduce", "score_pairs"))
    sha = bench.lineset_sha256(lines)
    shapes = chunks[:len(chunks) // 5]  # one of run_main_path's 5 runs
    log(f"[8] {len(reads_s)} reads of 380,000-403,000 bp: chunks (rows, "
        f"width) {shapes} at CELLS {ov.CELLS}; {len(lines)} lines (native "
        f"{n_nat}), sha256 {sha} native {nat_sha}, launches {counts}; cold "
        f"{cold:.3f} s, steady {steady:.3f} s, peak {mib(peak)}; native "
        f"{nat_t} s on {threads} threads")
    full = [r * w for r, w in shapes if r * w > ov.CELLS - w]
    if (len(shapes) < 2 or not full
            or max(r * w for r, w in shapes) > ov.CELLS):
        raise AssertionError(f"no chunk was cut to the CELLS budget: "
                             f"{shapes}")
    if sha != nat_sha or not lines:
        raise AssertionError("CELLS-split line set differs")

    # ---- phase 9: shape limits (scratch in device memory) ----
    wide = {n: dict(err=0, launches=0, timings=[]) for n in
            ("min_reduce_w1", "weighted_min_reduce", "score_pairs")}
    # kernel 3 at S = 10,000 and 70,000 on candidate pairs of the
    # ultra-long mix's 16 long reads (70,000+ ordered 12-mers a strand)
    for S9, n_pairs in ((10_000, 8), (70_000, 2)):
        ov = TorchOverlapper(dict(ordered_sketch_size=S9), device="cuda")
        st, qg, cand = candidate_pairs(ov, reads_u[:16])
        if len(qg) < n_pairs:
            raise AssertionError(f"S={S9}: {len(qg)} candidate pairs")
        qi = torch.from_numpy(qg[:n_pairs].astype(np.int32)).to(dev)
        ci = torch.from_numpy(cand[:n_pairs].astype(np.int32)).to(dev)
        cols = st.scorer_cols()
        got = score_pairs(cols, cols, qi, ci, 0.2)
        gathered = ([c[qi.long()] for c in cols]
                    + [c[ci.long()] for c in cols])
        want = []
        plain_ms = once_ms(lambda: want.append(
            score_pairs_ref(*gathered, 0.2)))
        e = max_err([got], want)
        t = k3_timing(f"S={S9}: {n_pairs} ultra-long candidate pairs",
                      cols, cols, qi, ci, rate, reps=3)
        t.update(plain_ms=plain_ms, plan=scorer_plan(S9),
                 occupancy=occupancy(S9), m=int(cols[2].min()))
        wide["score_pairs"]["err"] = max(wide["score_pairs"]["err"], e)
        wide["score_pairs"]["timings"].append(t)
        log(f"[9] kernel 3 at S={S9} on {n_pairs} ultra-long pairs (ok "
            f"lanes {int(got[:, 0].sum())}): max|err| {e} vs plain; {t}")
        # kernel 4 past the parent design's S <= 7,264: 64 row pairs of
        # these sketches at OW = 2S (S = 10,000), 4 at OW = S (70,000)
        rows9, ow9 = (64, 2 * S9) if S9 == 10_000 else (4, S9)
        n_st = st.ordered_h.shape[0]
        r9 = torch.arange(rows9, device=dev)
        m9 = (merge_rows(st, r9 % n_st)
              + merge_rows(st, (r9 * 7 + rows9 + 3) % n_st))
        t = k4_timing(f"S={S9}: {rows9} row pairs of ultra-long sketches",
                      m9, ow9, rate, reps=3, plain=False)
        results["merge2"]["timings"].append(t)
        results["merge2"]["err"] = max(results["merge2"]["err"], t["err"])
        log(f"[9] kernel 4 at S={S9}, OW={ow9} on {rows9} row pairs: {t}")
        if t["err"]:
            raise AssertionError(f"kernel 4 at S={S9} differs")
        del st, cols, got, gathered, want, m9
    # kernel 2 at H = 2,048 and 16,384 on three of phase 2's repeat rows,
    # also with every k-mer of weight >= 2 through the heavy pass
    h9, v9 = code_rows(repeat_rows(reads)[1:4], k1, dev)
    args9 = weighted_inputs(h9, v9)
    for H9 in (2048, 16384):
        got = weighted_min_reduce(*args9, H9)
        want = []
        plain_ms = once_ms(lambda: want.append(
            mh.weighted_min_reduce_ref(*args9, H9)))
        e = max(max_err([got], want), max_err(
            [weighted_min_reduce(*args9, H9, heavy_min=2)], [got]))
        t = k2_timing(f"phase 2 repeat rows 1-3, H={H9}", args9, H9, rate,
                      reps=3)
        t.update(plain_ms=plain_ms, plan=minhash_plan(2, H9))
        wide["weighted_min_reduce"]["err"] = max(
            wide["weighted_min_reduce"]["err"], e)
        wide["weighted_min_reduce"]["timings"].append(t)
        log(f"[9] kernel 2 at H={H9} on {tuple(h9.shape)}: max|err| {e} vs "
            f"plain (and heavy_min 2); {t}")
    # kernel 1 at H = 16,384 on four primary reads
    seq9 = torch.from_numpy(np.frombuffer("".join(reads[:4]).encode(),
                                          np.uint8).reshape(4, -1).copy())
    h9 = murmur3.kmer_hashes_128(seq9.to(dev), k1)
    a9 = torch.ones_like(h9, dtype=torch.bool)
    H9 = 16384
    got = min_reduce_w1(h9, a9, H9)
    want = []
    plain_ms = once_ms(lambda: want.append(mh.min_reduce_w1_ref(h9, a9, H9)))
    e = max_err([got], want)
    t = dict(input=f"4 primary reads, H={H9}", shape=list(h9.shape), H=H9,
             ms=time_ms(lambda: min_reduce_w1(h9, a9, H9), reps=3),
             plain_ms=plain_ms, plan=minhash_plan(1, H9),
             **bound(h9.numel() * 9 + 4 * H9 * 4,
                     h9.numel() * H9 * OPS_PER_STREAM_STEP, rate))
    wide["min_reduce_w1"].update(err=e)
    wide["min_reduce_w1"]["timings"].append(t)
    log(f"[9] kernel 1 at H={H9} on {tuple(h9.shape)}: max|err| {e} vs "
        f"plain; {t}")
    del h9, v9, args9, seq9, a9, got, want
    # the CLI at those sizes, in this process (launches counted), against
    # native at the same flags
    reads24 = ultra_long_mix(bench, seed=4246, genome_len=120_000,
                             lens=[12_000 + 347 * i for i in range(24)])
    mix = repeat_mix(bench)
    for name, rs, extra, need in (
            ("24 reads of 12-20 kb", reads24,
             ("--ordered-sketch-size", "10000"), ("score_pairs",)),
            ("primary", reads, ("--num-hashes", "2048"),
             ("weighted_min_reduce",)),
            ("repeat mix", mix, ("--num-hashes", "16384"),
             ("min_reduce_w1", "weighted_min_reduce"))):
        _, n_nat, threads, nat_sha, nat_t = bench.bench_native(
            rs, extra=extra)
        fa = write_fasta(os.path.join(tmp.name, "p9.fa"), rs)
        reset_counters(kern)
        torch.cuda.reset_peak_memory_stats()
        lines, secs = cli_in_process(["-s", fa, *extra])
        counts = read_counters(kern)
        for k in need:  # every such launch took the device-memory path
            wide[k]["launches"] += counts[k]
        add(counts, ("score_pairs",))
        sha = bench.lineset_sha256(lines)
        log(f"[9] CLI -s {' '.join(extra)} on {name}: {len(lines)} lines "
            f"(native {n_nat}), sha256 {sha[:16]} native {nat_sha[:16]}, "
            f"launches {counts}, {secs:.2f} s in process, peak "
            f"{mib(torch.cuda.max_memory_allocated())}; native {nat_t} s "
            f"on {threads} threads")
        if sha != nat_sha or not lines:
            raise AssertionError(f"CLI {extra} on {name} differs from "
                                 f"native")
    for n, w in wide.items():
        if w["err"] or w["launches"] == 0:
            raise AssertionError(f"{n}'s device-memory path: {w}")

    # ---- phase 10: the Canu path ----
    from mhap_tpu_torch.cli.main import (build_overlapper, run_overlap,
                                         run_precompute)
    from mhap_tpu_torch.cli.options import build_options
    from mhap_tpu_torch.io import datstore
    from mhap_tpu_torch.io.fasta import open_text
    from mhap_tpu_torch.io.filter import FrequencyCounts

    canu = os.path.join(tmp.name, "canu")
    reads_c, blocks, kpath = canu_input(bench, canu, CANU_READS)
    flags = ["-f", kpath, "--supress-noise", "2", "--repeat-weight", "0.9",
             "--repeat-idf-scale", "10"]
    dats, qdir = os.path.join(canu, "dats"), os.path.join(canu, "querydir")
    os.makedirs(dats)
    os.makedirs(qdir)
    # (a) -p, then -s block0.dat -q querydir, as subprocesses
    _, p_s = cli_process(["-p", blocks, "-q", dats] + flags)
    dat_sha = {b: hashlib.sha256(open(os.path.join(dats, b), "rb").read()
                                 ).hexdigest() for b in CANU_DAT_SHA256}
    shutil.copy(os.path.join(dats, "block1.dat"), qdir)
    argv_sq = ["-s", os.path.join(dats, "block0.dat"), "-q", qdir] + flags
    lines, sq_s = cli_process(argv_sq)
    sha = bench.lineset_sha256(lines)
    # (b) the same blocks as FASTA: query ids offset by the box's reads
    half = CANU_READS // 2
    fa_lines, fa_s = cli_process(["-s", os.path.join(blocks, "block0.fa"),
                                  "-q", os.path.join(blocks, "block1.fa")]
                                 + flags)
    fa_as_dat = sorted(
        " ".join([str(int(x[0]) - half)] + x[1:]) if int(x[0]) > half
        else line for line, x in ((ln, ln.split()) for ln in fa_lines))
    log(f"[10] Canu path, {CANU_READS} reads in two blocks: -p {p_s:.1f} s,"
        f" .dat sha256 {dat_sha}; -s block0.dat -q querydir: {len(lines)} "
        f"lines (JAX CLI {CANU_LINES}), sha256 {sha[:16]} (JAX "
        f"{CANU_SHA256[:16]}), {sq_s:.1f} s; -s block0.fa -q block1.fa: "
        f"{len(fa_lines)} lines in {fa_s:.1f} s, equal to the .dat run "
        f"with query ids less {half}: {fa_as_dat == lines} (subprocesses)")
    if (dat_sha != CANU_DAT_SHA256 or len(lines) != CANU_LINES
            or sha != CANU_SHA256 or fa_as_dat != lines):
        raise AssertionError("Canu path differs from the JAX CLI's goldens")
    # (c) the same two steps in this process, launches counted: the
    # device membership and weights of every chunk of -p against the
    # host's numpy bloom, kernel 2 against its plain version on the first
    # chunk's 4 rows of largest weight, and timings
    o = build_options()
    dats2 = os.path.join(canu, "dats2")
    os.makedirs(dats2)
    assert o.process(["-p", blocks, "-q", dats2] + flags)
    ov = build_overlapper(o)
    vf = ov.kmer_filter
    with open_text(kpath) as f:  # the host's copy of the CLI's filter
        fc_host = FrequencyCounts(f, 1e-5, 0.9, 2, False, 10.0, True,
                                  use_bloom=True)
    same_words = bool((fc_host.valid.words == vf.valid.words.cpu()).all())
    chunks = []
    sketch_chunk = ov._sketch_chunk

    def recorded(codes, lens):
        chunks.append((codes, lens))
        return sketch_chunk(codes, lens)

    ov._sketch_chunk = recorded
    reset_counters(kern)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        run_precompute(o, ov)
    torch.cuda.synchronize()
    p_cold = time.perf_counter() - t0
    counts_p = read_counters(kern)
    add(counts_p, ("weighted_min_reduce",))
    same_dat = all(open(os.path.join(dats, b), "rb").read()
                   == open(os.path.join(dats2, b), "rb").read()
                   for b in CANU_DAT_SHA256)
    words = vf.valid.words.cpu().numpy()
    bad_m = bad_w = 0
    n_keys = 0
    for codes, lens in chunks:
        hc = murmur3.kmer_hashes_128(torch.from_numpy(codes).to(dev), k1)
        vc = (torch.arange(hc.shape[1], device=dev)[None]
              < torch.from_numpy(lens - k1 + 1).to(dev)[:, None])
        g = mh.sort_and_count(hc, vc)
        keys, cnt = g["h"][g["first"]], g["count"][g["first"]]
        member = bloom_member_np(words, vf.valid.bit_size,
                                 vf.valid.num_hashes, keys.cpu().numpy())
        bad_m += int((vf.member(keys).cpu().numpy() != member).sum())
        bad_w += int((vf.weights(keys, cnt, 0.9).cpu().numpy()
                      != mode2_weights_np(fc_host, member,
                                          keys.cpu().numpy(),
                                          cnt.cpu().numpy())).sum())
        n_keys += len(keys)
    codes, lens = chunks[0]
    hc = murmur3.kmer_hashes_128(torch.from_numpy(codes).to(dev), k1)
    vc = (torch.arange(hc.shape[1], device=dev)[None]
          < torch.from_numpy(lens - k1 + 1).to(dev)[:, None])
    args10 = weighted_inputs(hc, vc, ov._weights)
    top = torch.topk(args10[1].max(dim=1).values, 4).indices
    sub = tuple(a[top] for a in args10)
    e10 = max_err([weighted_min_reduce(*sub, H)],
                  [mh.weighted_min_reduce_ref(*sub, H)])
    t10 = k2_timing("Canu -p first chunk", args10, H, rate)
    k2["timings"].append(t10)
    k2["err"] = max(k2["err"], e10)
    del hc, vc, args10, sub, chunks
    log(f"[10] -p in process: {p_cold:.2f} s cold, launches {counts_p}, "
        f".dat files equal to the subprocess's: {same_dat}; bloom "
        f"{vf.valid.bit_size} bits, {vf.valid.num_hashes} hashes: "
        f"{n_keys} k-mers of every chunk, {bad_m} device memberships and "
        f"{bad_w} device weights differ from the host's numpy; kernel 2 "
        f"on the first chunk: {t10}, max|err| {e10} vs plain on its 4 "
        f"rows of largest weight")
    if not same_dat or not same_words or bad_m or bad_w or e10:
        raise AssertionError("Canu path: device membership, weights or "
                             "kernel 2 differ from the host")
    o = build_options()
    assert o.process(argv_sq)
    ov = build_overlapper(o)
    walls = []
    for run in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counters(kern)
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            run_overlap(o, ov)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if run == 0:
            counts_sq = read_counters(kern)
            peak_sq = torch.cuda.max_memory_allocated()
            add(counts_sq, ("score_pairs",))
        if sorted(out.getvalue().splitlines()) != lines:
            raise AssertionError("in-process -s .dat -q differs")
    S = ov.cfg["ordered_sketch_size"]
    box = datstore.read_dat(os.path.join(dats, "block0.dat"), sketch_size=S)
    queries = datstore.read_dat(os.path.join(qdir, "block1.dat"),
                                box.n_real // 2, fwd_only=True,
                                sketch_size=S)
    qg, cand = ov._candidates(box, ov._build_index(box), queries,
                              np.arange(len(queries)), False)
    t10 = k3_timing("Canu -s .dat -q: query candidate pairs",
                    queries.scorer_cols(), box.scorer_cols(),
                    torch.from_numpy(qg.astype(np.int32)).to(dev),
                    torch.from_numpy(cand.astype(np.int32)).to(dev), rate)
    results["score_pairs"]["timings"].append(t10)
    log(f"[10] -s block0.dat -q querydir in process: cold {walls[0]:.3f} s,"
        f" steady {statistics.median(walls[1:]):.3f} s, peak "
        f"{mib(peak_sq)}, launches {counts_sq}; kernel 3 on the query "
        f"part's {len(qg)} candidate pairs: {t10}")
    del box, queries
    # (d) mode 1 (the exact set), library overlap_self on all the reads
    with open_text(kpath) as f:
        fc1 = FrequencyCounts(f, 1e-5, 0.9, 1, False, 10.0, True)
    ov = TorchOverlapper(device="cuda", kmer_filter=VectorFrequencyFilter(
        fc1, "cuda"))
    lines, counts, cold, steady, peak = run_main_path(ov, reads_c, kern,
                                                      n_timed=1)
    add(counts, ("weighted_min_reduce", "score_pairs"))
    sha = bench.lineset_sha256(lines)
    log(f"[10] mode 1, library overlap_self on {CANU_READS} reads: "
        f"{len(lines)} lines (JAX {CANU_MODE1_LINES}), sha256 {sha[:16]} "
        f"(JAX {CANU_MODE1_SHA256[:16]}), launches {counts}; cold "
        f"{cold:.3f} s, steady {steady:.3f} s, peak {mib(peak)}")
    if len(lines) != CANU_MODE1_LINES or sha != CANU_MODE1_SHA256:
        raise AssertionError("mode 1 differs from the JAX golden")
    # (e) mode 2 with the bloom, library, the recipe at 512 reads
    reads_e, _, kpath_e = canu_input(bench, os.path.join(tmp.name, "c512"),
                                     512)
    with open_text(kpath_e) as f:
        fc2 = FrequencyCounts(f, 1e-5, 0.9, 2, False, 10.0, True,
                              use_bloom=True)
    ov = TorchOverlapper(device="cuda", kmer_filter=VectorFrequencyFilter(
        fc2, "cuda"))
    lines, counts, cold, steady, peak = run_main_path(ov, reads_e, kern,
                                                      n_timed=1)
    add(counts, ("weighted_min_reduce", "score_pairs"))
    sha = bench.lineset_sha256(lines)
    log(f"[10] mode 2 (bloom), library overlap_self on 512 reads: "
        f"{len(lines)} lines (JAX {CANU512_LINES}), sha256 {sha[:16]} (JAX "
        f"{CANU512_SHA256[:16]}), launches {counts}; cold {cold:.3f} s, "
        f"steady {steady:.3f} s, peak {mib(peak)}")
    if len(lines) != CANU512_LINES or sha != CANU512_SHA256:
        raise AssertionError("512-read mode 2 differs from the JAX golden")

    # ---- phase 11: the sharded path (mhap_tpu_torch/parallel) ----
    sharded_phase(bench, kern, add, launches, native_sha, run5, reads10k,
                  reads_f, fc, tmp.name)

    # ---- phase 12: EstimateROC and kernel 5 ----
    roc_phase(bench, kern, add, results, roc_inputs, tmp.name)
    del roc_inputs

    # ---- phase 13: kernel 6 and --backend oracle ----
    bits_phase(bench, kern, add, results, reads, tmp.name)

    # ---- phase 14: scale40k and scale100k against native ----
    scale_phase(bench, kern, add, tmp.name)

    for name in path_kernels:
        if launches[name] == 0:
            raise AssertionError(f"{name} never ran on a path: {launches}")
    launches["merge2"] = merge_launches
    bad_mods = [m for m in sys.modules if m.split(".")[0] in ("jax",
                                                              "mhap_tpu")]
    if bad_mods:
        raise AssertionError(f"imported {bad_mods[:5]}")
    tmp.cleanup()

    src = {"min_reduce_w1": ("mhap_tpu_torch/csrc/minhash.cu",
                             "mhap_tpu/ops/minhash_pallas.py:156"),
           "weighted_min_reduce": ("mhap_tpu_torch/csrc/minhash.cu",
                                   "mhap_tpu/ops/minhash_pallas.py:193"),
           "score_pairs": ("mhap_tpu_torch/csrc/scorer.cu",
                           "mhap_tpu/ops/scorer_pallas.py:471"),
           "merge2": ("mhap_tpu_torch/csrc/merge.cu",
                      "mhap_tpu/ops/merge_pallas.py:117 (no caller on the "
                      "overlap path, as in JAX: launches are phase 2's "
                      "checks)"),
           "sw_align_batch": ("mhap_tpu_torch/csrc/swalign.cu",
                              "mhap_tpu/ops/swalign.py:37 (a lax.scan, not "
                              "a Pallas kernel)"),
           "bit_similarity_matrix": (
               "mhap_tpu_torch/csrc/bits.cu",
               "mhap_tpu/sketches/bits.py:137 (jax.lax.population_count, "
               "not a Pallas kernel)")}
    entries = [
        {"name": n, "route": "cuda", "source": src[n][0],
         "replaces": src[n][1], "launches": launches[n],
         "max_abs_err": results[n]["err"], "ms": results[n]["ms"],
         "plain_ms": results[n]["plain_ms"],
         "bound_ms": results[n]["bound_ms"],
         "bound_by": results[n]["bound_by"],
         "library_ms": results[n]["library_ms"],
         **({"occupancy": results[n]["occupancy"]}
            if "occupancy" in results[n] else {}),
         "timings": results[n].get("timings", [])} for n in kern]
    # phase 9's paths: the first shape past the shared-memory limit, and
    # the launches of phase 9's CLI runs that took them
    for n, w in wide.items():
        first = w["timings"][0]
        entries.append(
            {"name": f"{n} (device-memory scratch)", "route": "cuda",
             "source": src[n][0], "replaces": src[n][1],
             "launches": w["launches"], "max_abs_err": w["err"],
             "ms": first["ms"], "plain_ms": first["plain_ms"],
             "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
             "library_ms": None, "timings": w["timings"]})
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
