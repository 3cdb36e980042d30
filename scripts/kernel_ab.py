#!/usr/bin/env python3
"""Times the port's kernels alone on the GPU at the main path's shapes,
each beside its bound, so that two trees can be compared in one call:

    python3 scripts/kernel_ab.py PARENT_TREE    # then CHANGE, CHANGE, PARENT
    python3 scripts/kernel_ab.py TREE --kernels 5   # only kernel 5
    python3 scripts/kernel_ab.py TREE --kernels pack,6

Imports ``mhap_tpu_torch`` from the tree given (its kernels build into
that tree's ``mhap_tpu_torch/build``) and the inputs' recipes (``bench``,
``tests/torch_card_inputs.py``) and the card's peak rates
(``benchmark/peaks.py``) from this checkout.  Shapes: the strand pack on
the primary workload's reads, both strands, a third of them lower case
and every byte value in a last pair of rows, [2,047, 2,944]; kernel 1 on
the first 512 primary reads [512, 2,885] at H = 512; kernel 2 on the
repeat rows [65, 2,289] and on the first filtered2k chunk [1,024,
2,929] at its tf-idf weights; kernel 3 on all of filtered2k's candidate
pairs at S = 1,536; kernel 4 on the ordered sketches of the primary
workload's first 4,096 candidate pairs and of lognormal10k's first
32,768, [T, 1,536] -> [T, 3,072], timed three ways: through the wrapper,
as a call of its C entry on preallocated outputs (the wrapper's checks
and allocations left out), and as 20 wrapper calls back to back over 20
(the host's time a call hidden behind the card's queue); kernel 5 on
filtered2k's 1,713 disputed PPV pairs ([1,713, 2,889] and [1,713,
2,849]), its eight outputs' sha256 beside the JAX golden; kernel 6 on
the primary workload's 1-bit MinHash sketches ([2,048, 8] uint64 all
against all, and their uint32 view) and on [8,192, 8] uint64 words of
BITS_SEED, through the wrapper and as the card's time alone
(``device_ms``), each with the sha256 of its output.

Each time is CUDA events through the wrapper, median of 5 after a
warm-up, in ms.  Each bound is the least time the card could take: the
larger of the bytes (each input read once, each output written once)
over the card's bandwidth and the operations over its rate, INT32 (the
pack, kernels 1-4; benchmark/peaks.py), integer issue (kernel 5) or b1
tensor-core (kernel 6) below; None on a card peaks.py does not list.
Beside kernels 4 and 6, a library call as a yardstick (``library_ms``),
which the port never makes: ``torch.sort`` of each pair's packed keys
side by side, and an fp16 matmul of the unpacked bits of the uint64
words.  Prints one JSON line with the card's nvidia-smi name and power
limit.
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
# integer instructions an SM can start a clock: four schedulers issue one
# warp instruction each, to the ALU pipe or to the FMA pipe (where IMAD
# runs), and a fused DPX instruction takes one slot (kernel 5's rate)
INT_ISSUE_PER_SM_CLOCK = 128
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


def nvidia_smi(query: str = "name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(
    ).splitlines()[0]


def sm_rate(per_sm_clock: int) -> float:
    """SMs x ``per_sm_clock`` operations x the card's maximum SM clock, a
    second."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * per_sm_clock * float(nvidia_smi("clocks.max.sm").split()[0]) \
        * 1e6


def bound(nbytes: float, nops: float, rate: float | None = None) -> dict:
    """The least ms the card could take for ``nbytes`` and ``nops``
    operations at ``rate`` a second (the card's INT32 rate by default),
    and which of the two sets it; None on a card benchmark/peaks.py does
    not list.  Needs the repository's root on sys.path."""
    import torch

    from benchmark.peaks import PEAKS

    peaks = PEAKS.get(torch.cuda.get_device_name(0))
    if peaks is None:
        return dict(bound_ms=None)
    t_b = nbytes / peaks["bytes_per_s"]
    t_o = nops / (rate or peaks["int32_ops_per_s"])
    return dict(bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations")


def timed(ms: float, nbytes: float, nops: float,
          rate: float | None = None) -> dict:
    """ms beside its bound."""
    return dict(ms=ms, **bound(nbytes, nops, rate))


def unpacked_bits(x, dev):
    """[N, W] uint32 or uint64 words -> float16 [N, bits W] of their bits,
    0 or 1, on ``dev``: the operands of kernel 6's yardstick, an fp16
    matmul (exact for up to 2,048 bits a row)."""
    import numpy as np
    import torch

    by = torch.from_numpy(np.ascontiguousarray(x).view(np.uint8)).to(dev)
    shifts = torch.arange(8, device=dev, dtype=torch.uint8)
    return ((by[..., None] >> shifts) & 1).reshape(len(x), -1).half()


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


def queued_ms(fn, n: int = 20, reps: int = 5) -> float:
    """Median over ``reps`` of the time of n back-to-back fn() calls / n."""
    return time_ms(lambda: [fn() for _ in range(n)], reps) / n


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


def pack_args(reads, dev):
    """The strand pack's arguments on ``reads``: both strands of each, a
    third of the reads lower case and every byte value in a last pair of
    rows, from the second read's reverse strand on, as a chunk may start:
    (src, base, start, length, fwd, width)."""
    import numpy as np
    import torch

    text = "".join(r.lower() if i % 3 == 0 else r
                   for i, r in enumerate(reads)).encode()
    raw = torch.from_numpy(np.frombuffer(text + bytes(range(256)),
                                         np.uint8).copy())
    lens = [len(r) for r in reads]
    st, ln, fw = (torch.from_numpy(x.astype(np.int64))[3:].to(dev)
                  for x in (np.repeat(np.cumsum([0] + lens), 2),
                            np.repeat(lens + [256], 2),
                            np.tile([1, 0], len(lens) + 1)))
    base = int(st[0])
    return raw[base:].to(dev), base, st, ln, fw, -(-int(ln.max()) // 64) * 64


# The work of one call of each kernel, (bytes, operations[, rate]) for
# bound(): each input read once, each output written once.
def pack_work(src, base, st, ln, fw, width):
    return len(src) + len(st) * width, 0


def k1_work(h, act, H):
    """9 bytes a hash and its flag, H int32 a row out; every active hash
    through each of the H streams."""
    from benchmark.metrics.minhash_roofline import OPS_PER_STREAM_STEP

    return (h.numel() * 9 + h.shape[0] * H * 4,
            int(act.sum()) * H * OPS_PER_STREAM_STEP)


def k2_work(h, w, act, tiebreak, H):
    """17 bytes a hash, its weight, flag and tiebreak; each active hash
    through each stream as many times as its weight."""
    from benchmark.metrics.minhash_roofline import OPS_PER_STREAM_STEP

    return (h.numel() * 17 + h.shape[0] * H * 4,
            int(w[act].sum()) * H * OPS_PER_STREAM_STEP)


def k3_work(cols, qi, cj):
    """Each distinct row the pairs gather read once, its real (hash, pos)
    entries and two counts; two indices and 16 output columns a pair;
    ~8 INT32 operations a cursor step of two merge passes."""
    import torch

    rows = torch.unique(torch.cat([qi, cj]).long())
    m_sum = int(cols[2][qi.long()].sum() + cols[2][cj.long()].sum())
    return (int(cols[2][rows].sum()) * 8 + len(rows) * 8 + len(qi) * 72,
            2 * m_sum * 8)


def k4_work(a0, a1, b0, b1, out_width):
    """Four [T, S] int32 limbs in, two [T, OW] out; one 64-bit
    compare-select an output, 2 INT32 operations."""
    T, S = a0.shape
    return T * S * 16 + 2 * T * out_width * 4, 2 * T * out_width


def k5_work(q, qlen, r, rlen):
    """Both sequences in, eight int32 columns and a pair's lengths out;
    SW_OPS_PER_CELL a cell at the integer issue rate."""
    cells = int((qlen.long() * rlen.long()).sum())
    return (q.numel() + r.numel() + 40 * len(qlen),
            cells * SW_OPS_PER_CELL, sm_rate(INT_ISSUE_PER_SM_CLOCK))


def k6_work(x, y):
    """Both word sets ([N, W] numpy) in, a float32 [NA, NB] out; NA x NB
    x K bit MACs at the b1 tensor-core rate."""
    bits = x.shape[1] * x.dtype.itemsize * 8
    return (4 * len(x) * len(y) + (len(x) + len(y)) * bits // 8,
            2 * len(x) * len(y) * bits, sm_rate(TC_B1_OPS_PER_SM_CLOCK))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tree")
    ap.add_argument("--kernels", default="pack,1,2,3,4,5,6",
                    help="comma-separated kernels to time: pack, 1-6")
    a = ap.parse_args()
    tree = os.path.abspath(a.tree)
    which = set(a.kernels.split(","))
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import numpy as np
    import torch

    import bench
    import torch_card_inputs as ci

    sys.path.insert(0, tree)
    import mhap_tpu_torch
    from mhap_tpu_torch.ops import _build
    from mhap_tpu_torch.ops.merge import pack_keys
    from mhap_tpu_torch.ops.merge_kernels import merge2
    from mhap_tpu_torch.ops.minhash_kernels import (min_reduce_w1,
                                                    weighted_min_reduce)
    from mhap_tpu_torch.ops.pack_kernels import pack_strands
    from mhap_tpu_torch.ops.scorer_kernels import score_pairs
    from mhap_tpu_torch.ops.swalign_kernels import sw_align_batch
    from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper
    from mhap_tpu_torch.utils.seq import reverse_complement

    assert mhap_tpu_torch.__file__.startswith(tree), mhap_tpu_torch.__file__
    dev = torch.device("cuda")
    k1, H = 16, 512

    def k2_timed(args):
        return timed(time_ms(lambda: weighted_min_reduce(*args, H)),
                     *k2_work(*args, H))

    out = {"tree": tree}
    reads = bench.make_reads()
    if "pack" in which:
        args = pack_args(reads, dev)
        out[f"pack [{len(args[2])}, {args[5]}]"] = timed(
            time_ms(lambda: pack_strands(*args)), *pack_work(*args))
    if "1" in which:
        h = ci.primary_hashes(reads, 512, dev, k1)
        act = torch.ones_like(h, dtype=torch.bool)
        out["k1 [512, 2885] H=512"] = timed(
            time_ms(lambda: min_reduce_w1(h, act, H)), *k1_work(h, act, H))
    if "2" in which:
        out["k2 repeat rows [65, 2289]"] = k2_timed(ci.weighted_inputs(
            *ci.code_rows(ci.repeat_rows(reads), k1, dev)))
    if which & {"2", "3", "5"}:
        with tempfile.TemporaryDirectory() as td:
            reads_f, path = ci.filtered2k(bench, td)
            vf = VectorFrequencyFilter(ci.read_filter(path), dev)
    if "2" in which:
        strands = []
        for r in reads_f[:512]:
            strands += [r, reverse_complement(r)]
        out["k2 filtered2k chunk [1024, 2929]"] = k2_timed(
            ci.weighted_inputs(*ci.code_rows(strands, k1, dev),
                               lambda k, c: vf.weights(k, c, 0.9)))
    if "3" in which:
        store, qg, cand = ci.candidate_pairs(
            TorchOverlapper(device="cuda", kmer_filter=vf), reads_f)
        qi, cj = (torch.from_numpy(x.astype(np.int32)).to(dev)
                  for x in (qg, cand))
        cols = store.scorer_cols()
        out[f"k3 filtered2k {len(qg)} pairs S=1536"] = timed(
            time_ms(lambda: score_pairs(cols, cols, qi, cj, 0.2)),
            *k3_work(cols, qi, cj))
        del store, cols
    k4_rows = (("primary", reads, 4096),
               ("lognormal10k", bench.make_reads_placed(
                   10_000, seed=bench.SEED + 1)[0], 32768)) \
        if "4" in which else ()
    for name, rs, n in k4_rows:
        store, qg, cand = ci.candidate_pairs(TorchOverlapper(device="cuda"),
                                             rs)
        qi = torch.from_numpy(qg[:n].astype(np.int32)).to(dev)
        cj = torch.from_numpy(cand[:n].astype(np.int32)).to(dev)
        ma = ci.merge_rows(store, qi) + ci.merge_rows(store, cj)
        o = torch.empty((2, n, 3072), dtype=torch.int32, device=dev)
        args = [x.data_ptr() for x in ma] + [n, 1536, 3072,
                                             o[0].data_ptr(), o[1].data_ptr()]
        lib = _build.kernels()
        stream = torch.cuda.current_stream().cuda_stream
        key = f"k4 {name} [{n}, 1536] -> 3072"
        out[key] = timed(time_ms(lambda: merge2(*ma, out_width=3072)),
                         *k4_work(*ma, 3072))
        packed = torch.cat([pack_keys(*ma[:2]), pack_keys(*ma[2:])], dim=1)
        out[key]["library_ms"] = time_ms(lambda: torch.sort(packed, dim=1))
        del packed
        out[key + " C entry"] = time_ms(
            lambda: _build.check(lib.mhap_merge2(*args, stream), "merge2"))
        out[key + " queued"] = queued_ms(lambda: merge2(*ma, out_width=3072))
        if not all(map(torch.equal, o, merge2(*ma, out_width=3072))):
            raise AssertionError(f"{key}: C entry differs from the wrapper")
        del store, ma, o
    if "5" in which:
        lines = TorchOverlapper(device="cuda", kmer_filter=vf).overlap_self(
            reads_f)
        with tempfile.TemporaryDirectory() as td:
            args = ci.filtered2k_disputed(bench, td, lines)
        key = (f"k5 filtered2k {len(args[1])} disputed pairs "
               f"{list(args[0].shape)} x {list(args[2].shape)}")
        out[key] = timed(time_ms(lambda: sw_align_batch(*args)),
                         *k5_work(*args))
        out[key + " sha256 equal to the JAX golden"] = (
            ci.sw_sha256(sw_align_batch(*args))
            == ci.ROC_GOLDENS["filtered2k"]["sw_sha256"])
    if "6" in which:
        from mhap_tpu_torch.ops.bits import words
        from mhap_tpu_torch.ops.bits_kernels import bit_similarity
        from mhap_tpu_torch.sketches.bits import pack_last_bits_msb_first

        store = TorchOverlapper(device="cuda").sketch_reads(reads)
        bits64 = pack_last_bits_msb_first(
            store.host("minhash")[store.header_id != 0])
        big = np.random.default_rng(ci.BITS_SEED).integers(
            0, np.iinfo(np.uint64).max, (2, 8192, 8), dtype=np.uint64,
            endpoint=True)
        bits32 = bits64.view(np.uint32)
        for name, x, y in (("primary 1-bit sketches", bits64, bits64),
                           ("their uint32 view", bits32, bits32),
                           ("seeded words", big[0], big[1])):
            ka, kb = words(x, dev), words(y, dev)
            key = f"k6 {name} {list(x.shape)} x {list(y.shape)}"
            out[key] = timed(time_ms(lambda: bit_similarity(ka, kb)),
                             *k6_work(x, y))
            out[key]["device_ms"] = device_ms(lambda: bit_similarity(ka, kb))
            if x.dtype == np.uint64:
                ua, ub = unpacked_bits(x, dev), unpacked_bits(y, dev)
                out[key]["library_ms"] = time_ms(lambda: ua @ ub.T)
                del ua, ub
            out[key + " sha256"] = hashlib.sha256(
                bit_similarity(ka, kb).cpu().numpy().tobytes()
            ).hexdigest()[:16]
        del store
    out["card"] = nvidia_smi()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
