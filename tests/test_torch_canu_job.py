"""Canu's correction-stage MHAP job at Canu's own flags (the benchmark's
``canu-cor-mhap`` configuration: 768 hashes, 2 min matches, tf-idf
filter at repeat-idf-scale 10) on the port's CPU path, small: ``-p`` of
two FASTA blocks, then ``-s block0.dat -q <dir holding block1.dat>``
through ``cli.main.main``.  Every line equals the benchmark's plain
reference and the JAX package's CLI on the same ``.dat`` files, the
float32 control does not; with the tracer on, the ``.dat``, query and
header-format spans and counters are recorded and stdout does not change.

The read set is the benchmark's generator at a small law: at 768 hashes
and weight 10 the plain weighted MinHash steps 7,680 times over every
k-mer of a block, so two blocks of 6 reads keep the file near 30 s."""

import contextlib
import hashlib
import io
import json
import os

import pytest
import torch

from benchmark import compare, traffic
from benchmark.cell import ROOT
from mhap_tpu_torch.cli.main import main
from mhap_tpu_torch.utils import trace
from torch_cli_util import jax_cli_main

torch.set_num_threads(1)

with open(os.path.join(ROOT, "benchmark", "configs",
                       "canu-cor-mhap.json")) as _f:
    CONFIG = json.load(_f)
with open(os.path.join(ROOT, "benchmark", "traffic", "ecoli25x.json")) as _f:
    TRAFFIC = json.load(_f)
# 12 reads of 1,000-1,600 bases in two blocks, a 300-base repeat in 4
# copies and a filter file of the k-mers seen 3 times or more
SMALL = {"reads": 12, "coverage": 4.0,
         "length": {"median": 1200, "sigma": 0.3, "min": 1000, "max": 1600},
         "repeat": {"length": 300, "share": 0.3},
         "filter": {"k": 16, "cutoff": 1.4e-4, "top": 10000}}
SEED = 2**31 + 77


def quiet(argv, tracer: bool):
    """stdout of one CLI run on the CPU, and its job record when traced."""
    out = io.StringIO()
    if tracer:
        trace.enable()
    try:
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            assert main(argv, device="cpu") == 0
        jobs = trace.jobs()
    finally:
        trace.disable()
        trace.reset()
    return out.getvalue(), (jobs[0] if tracer else None)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The inputs, the -p jobs' records, the job's stdout untraced and
    traced and the traced job's record."""
    d = tmp_path_factory.mktemp("canu")
    inputs = traffic.make_inputs(dict(TRAFFIC, **SMALL), CONFIG, SEED,
                                 str(d))
    setup = [quiet(argv, True)[1] for argv in inputs.setup_argvs]
    plain, _ = quiet(inputs.job_argv, False)
    text, rec = quiet(inputs.job_argv, True)
    return inputs, setup, plain, text, rec


def test_flags_are_the_configurations(job):
    inputs, *_ = job
    assert compare.settings(CONFIG["flags"])["num_hashes"] == 768
    argv = inputs.job_argv
    for flag, value in CONFIG["flags"].items():
        assert argv[argv.index(flag) + 1] == str(value)
    assert argv[argv.index("-f") + 1] == inputs.filter_path


@pytest.fixture(scope="module")
def reference(job):
    """(every read number of a block, the reference's lines for them)."""
    inputs = job[0]
    ids = list(range(1, min(hi - lo for lo, hi in inputs.blocks) + 1))
    return ids, compare.expected_lines(inputs, CONFIG["flags"], ids, "cpu")


@pytest.mark.parametrize("f32", [False, True])
def test_lines_against_the_reference(job, reference, f32):
    """Every line of the job is the reference's, and every line of the
    reference the job's; the float32 control's are not."""
    inputs, _, plain, *_ = job
    ids, ref = reference
    text = plain if not f32 else "\n".join(compare.expected_lines(
        inputs, CONFIG["flags"], ids, "cpu", f32=True)) + "\n"
    numbers = compare.judge([[text]], ref, ids)
    assert numbers["lines_expected"] == plain.count("\n") > 10
    assert compare.passes(numbers) is not f32, numbers


def test_jax_cli_gives_the_same_line_set(job, capsys):
    """The JAX package's CLI on the same .dat files."""
    inputs, _, plain, *_ = job
    assert jax_cli_main(inputs.job_argv) == 0
    want = capsys.readouterr().out

    def digest(text):
        return hashlib.sha256(
            "\n".join(sorted(text.splitlines())).encode()).hexdigest()

    assert digest(want) == digest(plain)


def test_stdout_equal_with_the_tracer_off_and_on(job):
    _, _, plain, text, _ = job
    assert text == plain and text


@pytest.mark.parametrize("name,parents", [
    ("dat.parse", ["load", "load"]), ("query", ["job"]),
    # the filter's copies to the device, then each .dat file's
    ("load.wait", ["job", "load", "load"]),
    # the store against itself, then against the query file
    ("format.python", ["format", "format"])])
def test_job_spans(job, name, parents):
    """The job's new spans, each under its layer's span."""
    *_, rec = job
    spans = [s for s in rec.spans if s.name == name]
    assert rec.total(name) > 0
    assert [rec.spans[s.parent].name for s in spans] == parents


def test_job_counters(job):
    inputs, setup, _, _, rec = job
    c = rec.counters
    written = [s.counters["dat_records_written"] for s in setup]
    # both strands of every read of each block; the job reads block 0
    # whole and block 1's forward strands
    assert written == [2 * (hi - lo) for lo, hi in inputs.blocks]
    assert c["dat_records"] == written[0] + written[1] // 2
    q = inputs.job_argv[-1]
    assert c["dat_bytes"] == (os.path.getsize(inputs.job_argv[-3])
                              + os.path.getsize(os.path.join(q,
                                                             "block1.dat")))
    assert (c["query_files"], c["query_rows"]) == (1, written[1] // 2)
    assert c["m4_lines_python"] == c["matches_processed"] > 10
    assert c["m4_lines_native"] == 0
    for s in setup:
        assert s.total("dat.write") > 0 and s.total("dat.wait") > 0
