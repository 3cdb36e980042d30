"""One run of one benchmark cell: set-up, the measured window, the traced
jobs and the check.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, whose file that entry gives, and a traffic mix,
``traffic/<name>.json``; each per-layer metric is ``metrics/<name>.py``.
Nothing here names a cell, a configuration, a traffic mix or a metric.

Each job is one in-process call of the port's command line,
``mhap_tpu_torch.cli.main.main(argv)``, its standard output kept in memory
and its standard error dropped.  The window runs jobs back to back, one
client in a closed loop as MHAP and Canu run their jobs, until
``seconds`` have passed; the job in flight then finishes and counts.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

import torch

from . import compare, traffic
from .reference.overlaps import default_workers
from .spans import Spans
from .trace import Trace

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
GIB = float(1 << 30)
PROFILED_JOBS = 2


class Sink:
    """Standard output of a job: its writes, kept as they come."""

    def __init__(self):
        self.parts = []
        self.write = self.parts.append

    def flush(self):
        pass


class Null:
    def write(self, s):
        return len(s)

    def flush(self):
        pass


def load_metric(name: str, bench: str = BENCH):
    path = os.path.join(bench, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


def _for(entries, cell):
    return [m for m in entries if cell in m.get("workloads", [cell])]


class Cell:
    """A workload of the manifest with its configuration, traffic mix and
    metrics."""

    def __init__(self, name: str, root: str = ROOT):
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            man = json.load(f)
        ws = {w["name"]: w for w in man["workloads"]}
        if name not in ws:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.workload = ws[name]
        cfg = {c["name"]: c for c in man["configs"]}[self.workload["config"]]
        with open(os.path.join(root, cfg["file"])) as f:
            self.config = json.load(f)
        bench = os.path.join(root, "benchmark")
        with open(os.path.join(bench, "traffic",
                               self.workload["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        self.end_to_end = [m["name"] for m in _for(man["end_to_end"], name)]
        self.units = {m["name"]: m["unit"]
                      for m in man["end_to_end"] + man["per_layer"]}
        self.per_layer = {m["name"]: load_metric(m["name"], bench)
                          for m in _for(man["per_layer"], name)}


class Run:
    """What a traced run's metric readers read: the window's span times,
    the arguments kept from the profiled jobs' spans, and their trace."""

    def __init__(self, jobs, seconds, calls, kept, trace, card,
                 missing=()):
        self.jobs = jobs
        self.seconds = seconds
        self.calls = calls
        self._kept = kept
        self.trace = trace
        self.card = card
        self.missing = set(missing)

    def span_ms(self, names):
        """Milliseconds a window job spent in the spans ``names``, or None
        if none of them ran or one of them names no function of the
        program any more."""
        if not self.jobs or self.missing.intersection(names) or not any(
                self.calls.get(n) for n in names):
            return None
        return 1e3 * sum(self.seconds.get(n, 0.0) for n in names) / self.jobs

    def kept(self, name):
        return self._kept.get(name, [])


def run_job(cli, argv, device):
    out = Sink()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(Null()):
        rc = cli(argv, device=device)
    return rc, out.parts


def host_ticks() -> tuple:
    """(steal, all) clock ticks of the machine's CPUs so far, from
    /proc/stat: the time the hypervisor ran something else on them."""
    try:
        with open("/proc/stat") as f:
            t = [int(x) for x in f.readline().split()[1:]]
        return t[7], sum(t)
    except (OSError, IndexError, ValueError):
        return 0, 0


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: str = ROOT, t_start=None,
             traffic_override=None, workers=None,
             after_jobs=None) -> dict:
    """One run of cell ``name``.  Returns the result's fields: correct,
    attempted, failed, metrics, device, breakdown (traced) and check.
    ``after_jobs`` is called once the program's last job has ended,
    before the check."""
    t_start = time.perf_counter() if t_start is None else t_start
    from mhap_tpu_torch.cli.main import main as cli

    cell = Cell(name, root)
    spec = dict(cell.traffic, **(traffic_override or {}))
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    workdir = tempfile.mkdtemp(prefix="mhap-bench-")
    spans = None
    try:
        inputs = traffic.make_inputs(spec, cell.config, seed, workdir)
        for argv in inputs.setup_argvs:
            rc, _ = run_job(cli, argv, device)
            if rc != 0:
                raise RuntimeError(f"set-up {argv} returned {rc}")
        if trace:
            names = [n for m in cell.per_layer.values() for n in m.SPANS]
            keep = [n for m in cell.per_layer.values()
                    for n in getattr(m, "KEEP", [])]
            spans = Spans(names, sync if cuda else None, keep)
            spans.install()
        # the first window job's output and the latest one's; a job's
        # text is dropped when the next ends, as a file's writes would be
        outputs = []
        rc, parts = run_job(cli, inputs.job_argv, device)  # warm-up
        if rc != 0:
            raise RuntimeError(f"warm-up job returned {rc}")
        if spans:
            spans.reset()
        sync()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s, {inputs.bases} bases a job")
        attempted = failed = done = 0
        ends = []
        steal0, all0 = host_ticks()
        t0 = time.perf_counter()
        c0 = os.times()
        while True:
            attempted += 1
            try:
                rc, parts = run_job(cli, inputs.job_argv, device)
            except Exception:
                traceback.print_exc()
                rc = None
            if rc != 0:
                failed += 1
                break
            done += 1
            outputs[1:] = [parts]
            ends.append(time.perf_counter() - t0)
            if ends[-1] >= seconds:
                break
        sync()
        window = time.perf_counter() - t0
        c1 = os.times()
        steal1, all1 = host_ticks()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        del parts
        log(f"window {window:.3f} s, {done} jobs, peak {peak} bytes, "
            f"process CPU user {c1.user - c0.user:.2f} s system "
            f"{c1.system - c0.system:.2f} s, host steal "
            f"{100 * (steal1 - steal0) / max(1, all1 - all0):.2f} %, "
            f"jobs ended at {[round(t, 3) for t in ends]}")
        metrics, dev = {}, {"platform": "gpu" if cuda else "cpu",
                            "kind": (torch.cuda.get_device_name()
                                     if cuda else "cpu"),
                            "count": 1, "memory_peak_bytes": peak}
        breakdown = None
        if not trace:
            values = {"mbases_per_s": done * inputs.bases / 1e6 / window,
                      "peak_device_gib": peak / GIB, "setup_s": setup_s}
            for m in cell.end_to_end:
                metrics[m] = {"value": values[m], "unit": cell.units[m]}
        else:
            seconds, calls = dict(spans.seconds), dict(spans.calls)
            tr = None
            if cuda and done and not failed:
                tr, more = _profile(cli, inputs.job_argv, device, spans,
                                    workdir)
                outputs += more
                dev["busy_s"] = tr.busy_s
                dev["window_s"] = tr.window_s
                breakdown = {"device_ops": tr.top_ops(),
                             "idle_gaps": tr.idle_by_span()}
            spans.uninstall()
            run = Run(done, seconds, calls, spans.kept, tr, dev["kind"],
                      spans.missing)
            for m, mod in cell.per_layer.items():
                v = mod.read(run)
                if v is not None:
                    metrics[m] = {"value": float(v), "unit": cell.units[m]}
            spans.kept.clear()
        if after_jobs is not None:
            after_jobs()
        t1 = time.perf_counter()
        ids = compare.sample_ids(inputs, spec["check"]["queries"])
        ref = compare.expected_lines(
            inputs, cell.config["flags"], ids, device,
            workers=default_workers() if workers is None else workers)
        numbers = compare.judge(outputs, ref, ids)
        log(f"check {time.perf_counter() - t1:.3f} s, {len(ids)} queries, "
            f"{sum(p.count(chr(10)) for p in outputs[0]) if outputs else 0}"
            f" lines a job")
        result = {"correct": not failed and compare.passes(numbers),
                  "attempted": attempted, "failed": failed,
                  "metrics": metrics, "device": dev}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["check"] = {k: {"value": v, "limit": compare.LIMITS[k][0],
                               "at_most": compare.LIMITS[k][1]}
                           for k, v in numbers.items()}
        return result
    finally:
        if spans is not None:
            spans.uninstall()
        shutil.rmtree(workdir, ignore_errors=True)


def _profile(cli, argv, device, spans, workdir):
    """PROFILED_JOBS more jobs under torch.profiler, the spans marked in
    its trace.  Returns (Trace, the jobs' outputs)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    spans.annotate = True
    spans.keeping = True
    outputs = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("bench/window"):
            for _ in range(PROFILED_JOBS):
                rc, parts = run_job(cli, argv, device)
                if rc != 0:
                    raise RuntimeError(f"profiled job returned {rc}")
                outputs.append(parts)
            torch.cuda.synchronize()
    spans.annotate = False
    spans.keeping = False
    path = os.path.join(workdir, "trace.json")
    prof.export_chrome_trace(path)
    tr = Trace(path)
    os.remove(path)
    return tr, outputs


def banned_modules() -> list:
    """Top-level modules of JAX or of the JAX package loaded in this
    process."""
    banned = {"jax", "jaxlib", "flax", "mhap_tpu"}
    return sorted({m.split(".", 1)[0] for m in sys.modules} & banned)
