"""The port's tracer (``mhap_tpu_torch/utils/trace.py``): off it records
nothing and changes no output; on, a CLI job on the CPU records every
layer's span, nested and on one job id, with self times that add up to the
job and the overlapper's integer stats as the job's counters; annotated,
the spans are ``mhap/<name>`` ranges of a ``torch.profiler`` trace, nested
as in memory.  The names the benchmark's own spans wrap still resolve."""

import contextlib
import io
import json

import numpy as np
import pytest
import torch

from mhap_tpu_torch.cli import main as cli
from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper
from mhap_tpu_torch.utils import trace

torch.set_num_threads(1)

FLAGS = ["--num-hashes", "64", "--ordered-sketch-size", "128",
         "--num-min-matches", "2"]
ROWS = 64  # rows a sketch chunk, so that the job's reads take several
LAYERS = ["job", "load", "sketch", "sketch.prepare", "sketch.chunk",
          "sketch.pack", "sketch.wait", "sketch.skip", "index", "vote",
          "vote.wait", "score", "score.wait", "identity", "format", "sort",
          "write"]


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.annotate(False)
    trace.reset()
    yield
    trace.disable()
    trace.annotate(False)
    trace.reset()


@pytest.fixture(scope="module")
def reads_file(tmp_path_factory):
    """300 reads of 80-600 bases at 5 % error off a 12 kb genome: some
    shorter than --min-olap-length, most overlapping."""
    rng = np.random.default_rng(7)
    genome = rng.choice(list("ACGT"), 12_000)
    out = []
    for i in range(300):
        n = int(rng.integers(80, 600))
        p = int(rng.integers(0, len(genome) - n))
        r = genome[p:p + n].copy()
        flip = rng.random(n) < 0.05
        r[flip] = rng.choice(list("ACGT"), int(flip.sum()))
        out.append(f">r{i}\n{''.join(r)}\n")
    path = tmp_path_factory.mktemp("trace") / "reads.fa"
    path.write_text("".join(out))
    return str(path)


def count(job, name):
    return sum(s.name == name for s in job.spans)


def run_job(path, monkeypatch):
    """One CLI job on the CPU: (its stdout, the overlapper it built)."""
    made = []
    build = cli.build_overlapper

    def keep(*a, **k):
        made.append(build(*a, **k))
        return made[-1]

    monkeypatch.setattr(cli, "build_overlapper", keep)
    monkeypatch.setattr(TorchOverlapper, "ROWS", ROWS)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["-s", path, *FLAGS], device="cpu") == 0
    return out.getvalue(), made[0]


@pytest.fixture(scope="module")
def traced(reads_file):
    """(stdout untraced, stdout traced, the traced job, its overlapper,
    its reads of at least --min-olap-length)."""
    with pytest.MonkeyPatch.context() as mp:
        trace.disable()
        trace.reset()
        plain, _ = run_job(reads_file, mp)
        assert trace.jobs() == []
        trace.enable()
        try:
            text, ov = run_job(reads_file, mp)
            jobs = trace.jobs()
        finally:
            trace.disable()
            trace.reset()
    with open(reads_file) as f:
        n = sum(len(line) - 1 >= ov.cfg["min_olap_length"]
                for line in f if not line.startswith(">"))
    assert len(jobs) == 1
    return plain, text, jobs[0], ov, n


def test_off_records_nothing_and_shares_one_object():
    a, b = trace.span("sketch"), trace.span("job")
    assert a is b
    with a as s:
        s.set_counters({"x": 1})
    assert trace.jobs() == []


def test_stdout_equal_with_the_tracer_off_and_on(traced):
    plain, text, *_ = traced
    assert text == plain and text.count("\n") > 20


def test_every_layer_span_recorded(traced):
    _, _, job, ov, n = traced
    names = {s.name for s in job.spans}
    assert set(LAYERS) <= names, set(LAYERS) - names
    chunks = -(-2 * n // ROWS)  # both strands of each read kept
    assert count(job, "sketch.chunk") == count(job, "sketch.pack") == chunks
    for layer in ("sketch", "index", "vote", "score", "identity", "format",
                  "sort"):
        assert count(job, layer) == 1, layer


def test_children_lie_inside_their_parent_on_one_job(traced):
    _, _, job, *_ = traced
    root, *rest = job.spans
    assert (root.name, root.parent) == ("job", -1)
    assert all(s.job == job.id for s in job.spans)
    for i, s in enumerate(rest, 1):
        p = job.spans[s.parent]
        assert 0 <= s.parent < i
        assert p.t0 <= s.t0 <= s.t1 <= p.t1, (s, p)
    parents = {(job.spans[s.parent].name, s.name) for s in rest}
    assert {("sketch.chunk", "sketch.pack"), ("sketch.chunk", "sketch.wait"),
            ("sketch.skip", "sketch.wait"), ("vote", "vote.wait"),
            ("score", "score.wait"), ("job", "write")} <= parents


def test_self_times_add_up_to_the_job(traced):
    _, _, job, *_ = traced
    names = {s.name for s in job.spans}
    assert sum(job.self_time(n) for n in names) == job.total("job") > 0
    # the sketch's three parts: host work, launches and waits
    prep = (job.total("sketch") - job.self_time("sketch.chunk")
            - job.total("sketch.wait"))
    assert prep > 0 and job.self_time("sketch.chunk") > 0


def test_counters_are_the_overlappers_integer_stats(traced):
    """The job's counters: the overlapper's integer stats and its counts
    of M4 lines formatted in C and in Python, which stay out of the
    stats (the CLI's stats block)."""
    _, _, job, ov, _ = traced
    want = {k: v for k, v in ov.total_stats().items()
            if isinstance(v, int)}
    assert set(want) == {"matches_processed", "sequences_fully_compared",
                         "elements_processed", "sequences_hit",
                         "sequences_searched"}
    assert job.counters == {**want, "m4_lines_native": ov.m4_counts[
        "m4_lines_native"], "m4_lines_python": 0}
    assert 0 < want["matches_processed"] <= want["sequences_fully_compared"]
    assert job.counters["m4_lines_native"] == want["matches_processed"]


def test_spans_nest_and_close_on_errors_and_disable():
    trace.enable()
    with trace.span("job"):
        with trace.span("a"):
            trace.disable()
            with trace.span("b"):  # off: not recorded
                pass
        with pytest.raises(ValueError):
            with trace.span("c"):
                raise ValueError
    trace.enable()
    with trace.span("job"):
        pass
    first, second = trace.jobs()
    assert [s.name for s in first.spans] == ["job", "a"]
    assert (first.id, second.id) == (first.id, first.id + 1)
    assert first.self_time("job") == first.total("job") - first.total("a")
    trace.reset()
    assert trace.jobs() == []


def test_annotated_spans_are_profiler_ranges_nested_as_in_memory(
        reads_file, tmp_path, monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    trace.enable()
    trace.annotate(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_job(reads_file, monkeypatch)
    job, = trace.jobs()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e["name"].startswith("mhap/")]
    # opening order; a parent before a child that starts with it
    events.sort(key=lambda e: (e["ts"], -e["dur"]))
    assert [e["name"] for e in events] == \
        ["mhap/" + s.name for s in job.spans]
    open_ = []
    for e, s in zip(events, job.spans):
        while open_ and open_[-1]["ts"] + open_[-1]["dur"] < e["ts"] + \
                e["dur"]:
            open_.pop()
        want = job.spans[s.parent].name if s.parent >= 0 else None
        got = open_[-1]["name"][5:] if open_ else None
        assert got == want, (s, e)
        open_.append(e)


def test_the_benchmarks_span_names_resolve():
    """The benchmark wraps the port's functions by name; the spans above
    went in without renaming or inlining any of them."""
    from benchmark.cell import ROOT, load_metric
    from benchmark.spans import resolve

    with open(f"{ROOT}/BENCHMARK.json") as f:
        names = {n for m in json.load(f)["per_layer"]
                 for n in load_metric(m["name"]).SPANS}
    assert len(names) >= 11
    for name in names:
        resolve(name)
