#!/usr/bin/env python3
"""Stage breakdown of the port's overlap_self on one NVIDIA GPU.

    python3 profile_stages.py [--trace-dir DIR]

For the primary workload (bench.make_reads()), lognormal10k
(bench.make_reads_placed(10_000, seed=SEED + 1)) and filtered2k
(chip_smoke.filtered2k: 2,048 reads and a tf-idf filter file, read at
--supress-noise 0), after two settling runs:

  * three runs of overlap_self's stages, called in its order, each timed
    on the host clock with torch.cuda.synchronize() after it; the median
    of each stage over the three runs, in ms.  ``sketch_chunks`` is the
    part of ``sketch`` spent in the device chunks (hashing, filter
    weights, kernels 1/2, bottom-k); the rest of ``sketch`` is host work;
  * one more overlap_self under torch.profiler: its wall time, the device
    busy time as the union of the intervals of every kernel, copy and
    memset in the trace, the busy share (busy / wall), and the device time
    summed by kernel group.

Prints one JSON line per workload.  The Chrome traces are kept in DIR when
it is given.  Needs a CUDA GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def kernel_group(ev: dict) -> str:
    name = ev["name"]
    if ev["cat"] != "kernel":
        return "copies/memsets"
    if "score_pairs_kernel" in name:
        return "kernel 3 (score_pairs)"
    if "min_reduce" in name:  # kernel 1, kernel 2's three passes
        return "kernels 1/2 (min-reduce)"
    if "sort" in name.lower():
        return "sorts"
    return "other PyTorch kernels"


def device_time(trace_path: str) -> dict:
    """Union of device intervals (ms) and device time by group (ms)."""
    with open(trace_path) as f:
        d = json.load(f)
    evs = [e for e in d["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    groups: dict[str, float] = {}
    for e in evs:
        g = kernel_group(e)
        groups[g] = groups.get(g, 0.0) + e["dur"] / 1000
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in evs):
        if b <= end:
            continue
        busy += b - max(a, end)
        end = b
    return {"busy_ms": busy / 1000, "by_group_ms": groups}


def stage_times(ov, reads) -> tuple:
    """overlap_self's stages, each synchronised and timed: ({stage:
    seconds}, candidate pairs, sorted lines, {"store_rows": rows of the
    store, "vote_peak_bytes": peak device memory allocated during the
    vote})."""
    import numpy as np
    import torch

    sync = torch.cuda.synchronize
    chunk = []
    orig = ov._sketch_chunk

    def timed_chunk(*a):
        sync()
        t = time.perf_counter()
        r = orig(*a)
        sync()
        chunk.append(time.perf_counter() - t)
        return r

    ov._sketch_chunk = timed_chunk
    try:
        T = {}
        sync()
        t0 = time.perf_counter()
        store = ov.sketch_reads(reads)
        sync()
        t1 = time.perf_counter()
        T["sketch"], T["sketch_chunks"] = t1 - t0, sum(chunk)
        index = ov._build_index(store)
        sync()
        t2 = time.perf_counter()
        T["postings"] = t2 - t1
        torch.cuda.reset_peak_memory_stats()
        qg, cand = ov._candidates(store, index, store,
                                  np.nonzero(store.is_fwd)[0], True)
        sync()
        t3 = time.perf_counter()
        info = {"store_rows": len(store),
                "vote_peak_bytes": torch.cuda.max_memory_allocated()}
        T["vote"] = t3 - t2
        out = ov._score_dispatch(store, store, qg.astype(np.int32),
                                 cand.astype(np.int32))
        sync()
        t4 = time.perf_counter()
        T["score"] = t4 - t3
        score, raw, edges = ov._identity_scores(out)
        t5 = time.perf_counter()
        T["identity"] = t5 - t4
        acc = score >= ov.cfg["threshold"]
        lines = ov._format(store, store, qg[acc], cand[acc], score[acc],
                           raw[acc], edges[acc])
        t6 = time.perf_counter()
        T["format"] = t6 - t5
        lines = sorted(lines)
        t7 = time.perf_counter()
        T["sort"], T["total"] = t7 - t6, t7 - t0
    finally:
        ov._sketch_chunk = orig
    return T, len(qg), lines, info


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default=None,
                    help="keep the Chrome traces here")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_stages: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import bench
    from torch.profiler import ProfilerActivity, profile

    # the smoke run's own builders, so both scripts measure one input
    from chip_smoke import filtered2k, read_filter
    from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print("card:", smi.stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        reads_f, filter_path = filtered2k(bench, tmp)
        workloads = (
            ("primary", bench.make_reads(), None),
            ("lognormal10k",
             bench.make_reads_placed(10_000, seed=bench.SEED + 1)[0], None),
            ("filtered2k", reads_f, VectorFrequencyFilter(
                read_filter(filter_path), "cuda")))
        for name, reads, kmer_filter in workloads:
            ov = TorchOverlapper(device="cuda", kmer_filter=kmer_filter)
            ov.overlap_self(reads)
            ov.overlap_self(reads)
            runs = [stage_times(ov, reads) for _ in range(3)]
            med = {k: statistics.median(r[0][k] for r in runs)
                   for k in runs[0][0]}
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                ov.overlap_self(reads)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            path = os.path.join(args.trace_dir or tmp, f"trace_{name}.json")
            if args.trace_dir:
                os.makedirs(args.trace_dir, exist_ok=True)
            prof.export_chrome_trace(path)
            dt = device_time(path)
            # times to the microsecond, the trace's resolution
            print(json.dumps({
                "workload": name, "pairs": runs[0][1],
                "lines": len(runs[0][2]),
                "stage_ms_median_of_3": {k: round(v * 1000, 3)
                                         for k, v in med.items()},
                "profiled_wall_ms": round(wall * 1000, 3),
                "device_busy_ms": round(dt["busy_ms"], 3),
                "device_busy_share": round(dt["busy_ms"] / (wall * 1000), 4),
                "device_ms_by_group": {k: round(v, 3) for k, v in
                                       dt["by_group_ms"].items()}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
