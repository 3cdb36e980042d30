#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mhap_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from mhap_tpu_torch/csrc, then:
  1. prints the card (nvidia-smi name and power limit), torch and CUDA
     versions and the kernel build time;
  2. holds each kernel against its plain PyTorch version on the card, at
     the main path's shapes, bit for bit (all outputs are integers), and
     times both (CUDA events, median of 5); the scorer kernel also against
     the native C++ scorer (native/scorer_ffi.cc mhap_score_pair), and
     kernels 1 and 3 once more on adversarial inputs (random masks and an
     empty row; tiny hash spaces at S = 1536);
  3. runs TorchOverlapper.overlap_self on the primary workload
     (bench.make_reads(): 1,024 reads x 2.9 kb): 4,349 lines whose
     line-set sha256 equals the native binary's on the same reads;
  4. a repeat mix (256 reads, 32 with an internal 500 bp duplication, 2
     with an ACGTTGCA x 200 tandem insert): line set equal to native's;
  5. lognormal10k (bench.make_reads_placed(10_000, seed=SEED + 1)):
     158,246 lines, line set equal to native's.
Every launch counter is set to 0 right before each main-path run of
phases 3-5 and read right after; a kernel the path never launched fails
the run.  The last stdout lines are the kernels' JSON line, the card's
nvidia-smi line and {"ok": true, "device": ...}.  Any failure exits
non-zero.  Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
EXPECTED_PRIMARY = 4349
EXPECTED_LOGNORMAL10K = 158246


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


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


def reset_counters(kern) -> None:
    for f in kern.values():
        f.launches = 0


def read_counters(kern) -> dict:
    return {name: f.launches for name, f in kern.items()}


def native_scorer():
    """ctypes handle on native/scorer_ffi.cc mhap_score_pair."""
    import numpy as np
    from mhap_tpu.utils import native

    fn = native._lib().mhap_score_pair
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
    from mhap_tpu.oracle.scorer import jaccard_to_identity
    from mhap_tpu_torch.ops import _build
    from mhap_tpu_torch.ops import minhash as mh
    from mhap_tpu_torch.ops import murmur3
    from mhap_tpu_torch.ops.minhash_kernels import (min_reduce_w1,
                                                    weighted_min_reduce)
    from mhap_tpu_torch.ops.scorer import COLS, score_pairs_ref
    from mhap_tpu_torch.ops.scorer_kernels import score_pairs
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    dev = torch.device("cuda")
    kern = {"min_reduce_w1": min_reduce_w1,
            "weighted_min_reduce": weighted_min_reduce,
            "score_pairs": score_pairs}
    # ---- phase 1: card, versions, build ----
    smi = nvidia_smi()
    log(f"[1] card: {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.kernels()
    log(f"[1] kernels built+loaded in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds} s) -> {_build.library_path()}")

    # ---- phase 2: kernels vs plain at the main path's shapes ----
    results = {}
    reads = bench.make_reads()
    k1, H = 16, 512
    codes = np.frombuffer("".join(reads[:512]).encode(), np.uint8)
    seq = torch.from_numpy(codes.reshape(512, -1).copy()).to(dev)
    h = murmur3.kmer_hashes_128(seq, k1)
    act = torch.ones_like(h, dtype=torch.bool)
    got = min_reduce_w1(h, act, H)
    want = mh.min_reduce_w1_ref(h, act, H)
    torch.cuda.synchronize()
    err1 = int((got.long() - want.long()).abs().max())
    # random masks, one empty row, one row past a register tile
    g1 = torch.Generator(device=dev).manual_seed(11)
    hr = torch.randint(-2**63, 2**63 - 1, (6, 9000), device=dev,
                       dtype=torch.int64, generator=g1)
    ar = torch.rand((6, 9000), device=dev, generator=g1) < 0.7
    ar[2] = False
    ar[3, 5000:] = False
    errx = int((min_reduce_w1(hr, ar, H).long()
                - mh.min_reduce_w1_ref(hr, ar, H).long()).abs().max())
    log(f"[2] kernel 1 on random rows [6, 9000] (empty row, masks): "
        f"max|err| {errx}")
    err1 = max(err1, errx)
    results["min_reduce_w1"] = dict(
        err=err1, ms=time_ms(lambda: min_reduce_w1(h, act, H)),
        plain_ms=time_ms(lambda: mh.min_reduce_w1_ref(h, act, H)))
    log(f"[2] kernel 1 min_reduce_w1 {tuple(h.shape)} H={H}: max|err| "
        f"{err1}, {results['min_reduce_w1']['ms']:.3f} ms vs plain "
        f"{results['min_reduce_w1']['plain_ms']:.3f} ms")

    # weights 1..4 (a 100 bp segment repeated up to 4 times) + one tandem
    # row with weights around 200
    rows = []
    for i, r in enumerate(reads[512:576]):
        rep = 1 + i % 4
        rows.append(r[:600] + r[600:700] * rep + r[700:2000])
    rows.append(reads[600][:300] + "ACGTTGCA" * 200 + reads[600][300:600])
    W = max(len(r) for r in rows)
    c2 = np.zeros((len(rows), W), np.uint8)
    ln = np.zeros(len(rows), np.int64)
    for i, r in enumerate(rows):
        c2[i, :len(r)] = np.frombuffer(r.encode(), np.uint8)
        ln[i] = len(r)
    seq2 = torch.from_numpy(c2).to(dev)
    h2 = murmur3.kmer_hashes_128(seq2, k1)
    v2 = (torch.arange(h2.shape[1], device=dev)[None, :]
          < torch.from_numpy(ln - k1 + 1).to(dev)[:, None])
    g = mh.sort_and_count(h2, v2)
    w2 = torch.where(g["first"], g["count"], 0)
    a2 = g["first"] & (w2 > 0)
    log(f"[2] kernel 2 rows: {tuple(h2.shape)}, max weight {int(w2.max())}")
    got = weighted_min_reduce(g["h"], w2, a2, g["tiebreak"], H)
    want = mh.weighted_min_reduce_ref(g["h"], w2, a2, g["tiebreak"], H)
    torch.cuda.synchronize()
    err2 = int((got.long() - want.long()).abs().max())
    results["weighted_min_reduce"] = dict(
        err=err2,
        ms=time_ms(lambda: weighted_min_reduce(g["h"], w2, a2,
                                               g["tiebreak"], H)),
        plain_ms=time_ms(lambda: mh.weighted_min_reduce_ref(
            g["h"], w2, a2, g["tiebreak"], H)))
    log(f"[2] kernel 2 weighted_min_reduce: max|err| {err2}, "
        f"{results['weighted_min_reduce']['ms']:.3f} ms vs plain "
        f"{results['weighted_min_reduce']['plain_ms']:.3f} ms")

    ov = TorchOverlapper(device="cuda")
    store = ov.sketch_reads(reads)
    qg, cand = ov._candidates(store, ov._build_index(store), store,
                              np.nonzero(store.is_fwd)[0], True)
    log(f"[2] primary workload: {len(qg)} candidate pairs")
    qi = torch.from_numpy(qg[:4096].astype(np.int32)).to(dev)
    ci = torch.from_numpy(cand[:4096].astype(np.int32)).to(dev)
    cols = store.scorer_cols()
    got = score_pairs(cols, cols, qi, ci, 0.2)
    ql, cl = qi.long(), ci.long()
    gathered = [c[ql] for c in cols] + [c[cl] for c in cols]
    want = score_pairs_ref(*gathered, 0.2)
    torch.cuda.synchronize()
    err3 = int((got.long() - want.long()).abs().max())
    results["score_pairs"] = dict(
        err=err3, ms=time_ms(lambda: score_pairs(cols, cols, qi, ci, 0.2)),
        plain_ms=time_ms(lambda: score_pairs_ref(*gathered, 0.2)))
    # the native C++ automaton on the same pairs
    fn = native_scorer()
    host = [store.host(n) for n in ("ordered_h", "ordered_p", "ordered_m",
                                    "num_kmers")]
    g3 = got.cpu().numpy()
    nat_bad = native_check(fn, host, host, qg[:4096], cand[:4096], g3,
                           jaccard_to_identity)
    log(f"[2] kernel 3 score_pairs {len(qi)} pairs: max|err| {err3} vs "
        f"plain, {nat_bad} lanes differ from native, ok lanes "
        f"{int(g3[:, 0].sum())}, escal {int(g3[:, COLS.index('escal')].sum())}"
        f"; {results['score_pairs']['ms']:.3f} ms vs plain "
        f"{results['score_pairs']['plain_ms']:.3f} ms")
    # adversarial pairs at S = 1536: deep duplicate runs
    adv = adversarial_pairs(256, 1536, seed=bench.SEED)
    qa = [torch.from_numpy(x).to(dev) for x in adv[0]]
    ca = [torch.from_numpy(x).to(dev) for x in adv[1]]
    idx = torch.arange(256, device=dev, dtype=torch.int32)
    got_a = score_pairs(qa, ca, idx, idx, 0.2)
    want_a = score_pairs_ref(*qa, *ca, 0.2)
    torch.cuda.synchronize()
    err_a = int((got_a.long() - want_a.long()).abs().max())
    ga = got_a.cpu().numpy()
    nat_a = native_check(fn, adv[0], adv[1], range(256), range(256), ga,
                         jaccard_to_identity)
    log(f"[2] kernel 3 on 256 adversarial pairs: max|err| {err_a} vs "
        f"plain, {nat_a} lanes differ from native, ok lanes "
        f"{int(ga[:, 0].sum())}, mean shared entries "
        f"{ga[:, COLS.index('n_shared')].mean():.0f}")
    results["score_pairs"]["err"] = max(err3, err_a)
    nat_bad += nat_a
    failures = [n for n, r in results.items() if r["err"] != 0]
    if nat_bad:
        failures.append("score_pairs vs native")
    if failures:
        raise AssertionError(f"kernels disagree: {failures}")

    launches = dict.fromkeys(kern, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    def mib(b):
        return f"{b / 2**20:.1f} MiB"

    # ---- phase 3: primary workload ----
    _, n_nat, threads, nat_sha, nat_t = bench.bench_native(reads)
    ov = TorchOverlapper(device="cuda")
    lines, counts, cold, steady, peak = run_main_path(ov, reads, kern)
    add(counts)
    sha = bench.lineset_sha256(lines)
    log(f"[3] primary: {len(lines)} lines (native {n_nat}), sha256 "
        f"{sha[:16]} native {nat_sha[:16]}, launches {counts}; cold "
        f"{cold:.3f} s, steady {steady:.3f} s, peak {mib(peak)}; native "
        f"{nat_t} s on {threads} threads")
    if len(lines) != EXPECTED_PRIMARY or sha != nat_sha:
        raise AssertionError("primary workload line set differs")
    if counts["min_reduce_w1"] == 0 or counts["score_pairs"] == 0:
        raise AssertionError(f"primary run skipped a kernel: {counts}")

    # ---- phase 4: repeat mix ----
    mix = repeat_mix(bench)
    _, n_nat, _, nat_sha, _ = bench.bench_native(mix)
    ov = TorchOverlapper(device="cuda")
    lines, counts, cold, steady, peak = run_main_path(ov, mix, kern)
    add(counts)
    sha = bench.lineset_sha256(lines)
    log(f"[4] repeat mix: {len(lines)} lines (native {n_nat}), sha256 "
        f"{sha[:16]} native {nat_sha[:16]}, launches {counts}; cold "
        f"{cold:.3f} s, steady {steady:.3f} s, peak {mib(peak)}")
    if sha != nat_sha or counts["weighted_min_reduce"] == 0:
        raise AssertionError("repeat mix differs or kernel 2 never ran")

    # ---- phase 5: lognormal10k ----
    reads10k, _, _ = bench.make_reads_placed(10_000, seed=bench.SEED + 1)
    _, n_nat, threads, nat_sha, nat_t = bench.bench_native(reads10k)
    ov = TorchOverlapper(device="cuda")
    lines, counts, cold, steady, peak = run_main_path(ov, reads10k, kern)
    add(counts)
    sha = bench.lineset_sha256(lines)
    log(f"[5] lognormal10k: {len(lines)} lines (native {n_nat}), sha256 "
        f"{sha} native {nat_sha}, launches {counts}; cold {cold:.3f} s, "
        f"steady {steady:.3f} s, peak {mib(peak)}; native {nat_t} s on "
        f"{threads} threads; stats {ov.stats}")
    if len(lines) != EXPECTED_LOGNORMAL10K or sha != nat_sha:
        raise AssertionError("lognormal10k line set differs")
    if min(launches.values()) == 0:
        raise AssertionError(f"a kernel of the path never ran: {launches}")
    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise AssertionError("JAX was imported")

    src = {"min_reduce_w1": ("mhap_tpu_torch/csrc/minhash.cu",
                             "mhap_tpu/ops/minhash_pallas.py:156"),
           "weighted_min_reduce": ("mhap_tpu_torch/csrc/minhash.cu",
                                   "mhap_tpu/ops/minhash_pallas.py:193"),
           "score_pairs": ("mhap_tpu_torch/csrc/scorer.cu",
                           "mhap_tpu/ops/scorer_pallas.py:471")}
    print(json.dumps({"kernels": [
        {"name": n, "route": "cuda", "source": src[n][0],
         "replaces": src[n][1], "launches": launches[n],
         "max_abs_err": results[n]["err"], "ms": results[n]["ms"],
         "plain_ms": results[n]["plain_ms"]} for n in kern]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
