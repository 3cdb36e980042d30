#!/usr/bin/env python3
"""The port's own spans (``mhap_tpu_torch/utils/trace.py``) on a benchmark
cell, on one CUDA card.

    python3 scripts/program_trace.py --workload W --seed N [--seconds 51]
        [--tracer 0|1]
    python3 scripts/program_trace.py --workload W --seed N --sync-audit

The first form is one traced run of the cell, as ``benchmark/run.py
--trace 1`` makes it (pinned, the benchmark's spans with their
synchronize, two profiled jobs after the window, the check), with the
port's tracer on (``--tracer 1``) or off: the tracer is enabled before the
warm-up job, its finished jobs dropped where the benchmark resets its own
spans, the window's jobs taken before the profiled ones, and the profiled
jobs annotated (``mhap/<name>`` ranges).  Prints one JSON line: the run's
result (``correct``, jobs, per-layer metrics) and, with the tracer on, in
ms a window job, each span's total and self time, the sketch's split into
host work (``sketch`` less the self time of ``sketch.chunk`` and the
``sketch.wait`` spans), launches (self time of ``sketch.chunk``) and
waits, every wait span, the job's counters with
``score_accept_pct`` = 100 x matches_processed / sequences_fully_compared,
and the profiled jobs' idle device time by the innermost ``mhap/`` span.

``--sync-audit`` makes the cell's inputs, runs one warm job, then one job
with the tracer on under ``torch.cuda.set_sync_debug_mode("warn")``, and
prints each call that synchronised the host with the card: the port's
frames that made it, the innermost span it ran in, and how often; those
outside every ``*.wait`` span are listed apart.

Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
import warnings
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def per_job(jobs) -> dict:
    """ms a job of each span's total and self time, the sketch's split,
    the wait spans and the counters, over ``jobs``."""
    n = len(jobs)
    names = sorted({s.name for j in jobs for s in j.spans})

    total = {k: sum(j.total(k) for j in jobs) / n / 1e6 for k in names}
    own = {k: sum(j.self_time(k) for j in jobs) / n / 1e6 for k in names}
    waits = {k: v for k, v in total.items() if k.endswith(".wait")}
    counters = Counter()
    for j in jobs:
        counters.update(j.counters)
    launch = own.get("sketch.chunk", 0.0)
    wait = total.get("sketch.wait", 0.0)
    compared = counters["sequences_fully_compared"]
    return {
        "jobs": n,
        "spans_a_job": sum(len(j.spans) for j in jobs) / n,
        "total_ms": total, "self_ms": own,
        "sketch_prep_ms": total.get("sketch", 0.0) - launch - wait,
        "sketch_launch_ms": launch, "sketch_wait_ms": wait,
        "readback_wait_ms": sum(waits.values()), "wait_ms": waits,
        "counters": {k: v / n for k, v in counters.items()},
        "score_accept_pct": (100.0 * counters["matches_processed"]
                             / compared if compared else None),
    }


def traced_run(args) -> dict:
    import torch

    from benchmark import cell as bc
    from benchmark.run import THREADS, steady_host
    from mhap_tpu_torch.utils import trace

    before = steady_host()
    torch.set_num_threads(THREADS)
    got = {}
    reset, profile = bc.Spans.reset, bc._profile

    def spans_reset(self):
        reset(self)
        trace.reset()

    def annotated_profile(*a, **k):
        got["window"] = trace.jobs()
        trace.annotate(True)
        try:
            return profile(*a, **k)
        finally:
            trace.annotate(False)

    class ProgramTrace(bc.Trace):
        """The benchmark's trace, with the idle time also put down to
        the innermost mhap/ span."""

        def __init__(self, path):
            super().__init__(path)
            with open(path) as f:
                ev = json.load(f)["traceEvents"]
            bench, self.spans = self.spans, [
                e for e in ev if e.get("ph") == "X"
                and e.get("cat") == "user_annotation"
                and e["name"].startswith("mhap/")]
            got["idle_by_mhap_span"] = self.idle_by_span(20)
            self.spans = bench

    bc.Spans.reset, bc._profile, bc.Trace = (spans_reset,
                                             annotated_profile, ProgramTrace)
    if args.tracer:
        trace.enable()
    try:
        r = bc.run_cell(args.workload, args.seed, args.seconds, True, "cuda",
                        ROOT, time.perf_counter(),
                        after_jobs=lambda: os.sched_setaffinity(0, before))
        # no profiled jobs (a job failed, or no card): the window's alone
        window = got.get("window", trace.jobs())
    finally:
        trace.disable()
        trace.reset()
    out = {"workload": args.workload, "seed": args.seed,
           "tracer": args.tracer, "correct": r["correct"],
           "attempted": r["attempted"], "failed": r["failed"],
           "metrics": {k: v["value"] for k, v in r["metrics"].items()},
           "device": r["device"]["kind"]}
    if window:
        out["program"] = per_job(window)
        out["idle_by_mhap_span"] = got.get("idle_by_mhap_span")
    return out


def sync_audit(args) -> dict:
    import torch

    from benchmark import traffic
    from benchmark.cell import Cell, run_job
    from mhap_tpu_torch.cli.main import main as cli
    from mhap_tpu_torch.utils import trace

    cell = Cell(args.workload, ROOT)
    workdir = tempfile.mkdtemp(prefix="mhap-sync-")
    hits = []
    try:
        inputs = traffic.make_inputs(cell.traffic, cell.config, args.seed,
                                     workdir)
        for argv in inputs.setup_argvs + [inputs.job_argv]:  # warm
            assert run_job(cli, argv, "cuda")[0] == 0
        torch.cuda.synchronize()

        def seen(message, category, filename, lineno, file=None, line=None):
            t = time.perf_counter_ns()
            frames = [f"{os.path.relpath(fr.filename, ROOT)}:{fr.lineno}"
                      for fr in traceback.extract_stack()[:-1]
                      if "mhap_tpu_torch" in fr.filename]
            if str(message).startswith("called a synchronizing"):
                hits.append((t, frames))

        trace.enable()
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rc, _ = run_job(cli, inputs.job_argv, "cuda")
            finally:
                torch.cuda.set_sync_debug_mode("default")
        job, = trace.jobs()
    finally:
        trace.disable()
        trace.reset()
        shutil.rmtree(workdir, ignore_errors=True)
    sites = Counter()
    outside = Counter()
    for t, frames in hits:
        inside = [s for s in job.spans if s.t0 <= t <= s.t1]
        innermost = max(inside, key=lambda s: s.t0).name if inside else "-"
        key = (innermost, " < ".join(reversed(frames[-3:])))
        sites[key] += 1
        if not any(s.name.endswith(".wait") for s in inside):
            outside[key] += 1
    return {"workload": args.workload, "seed": args.seed, "rc": rc,
            "device": torch.cuda.get_device_name(),
            "syncs": len(hits), "outside_wait": sum(outside.values()),
            "sites": [[*k, v] for k, v in sites.most_common()],
            "sites_outside_wait": [[*k, v] for k, v in
                                   outside.most_common()]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--tracer", type=int, choices=(0, 1), default=1)
    ap.add_argument("--sync-audit", action="store_true")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA card", file=sys.stderr)
        return 2
    out = sync_audit(args) if args.sync_audit else traced_run(args)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
