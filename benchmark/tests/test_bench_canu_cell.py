"""The cell ``canu.ecoli25x``: Canu's correction-stage MHAP job
(configuration ``canu-cor-mhap``) on the read set ``ecoli25x``.  Its
flags are ones the reference runs; its blocks are Canu's 6,000 reads; its
filter file holds the repeat family's k-mers and no k-mer the genome
holds twice by chance; its two metrics read the port's ``.dat`` parse and
header-string format, and nothing where the program lacks them; a tiny
run of it on the CPU is correct and reads both."""

import json
import os

import pytest
import torch

from benchmark import compare, traffic
from benchmark.cell import ROOT, Cell, Run, load_metric, run_cell
from benchmark.spans import resolve

CELL = "canu.ecoli25x"
METRICS = ["dat_parse_ms", "header_format_ms"]


@pytest.fixture(scope="module")
def cell():
    return Cell(CELL)


@pytest.fixture(scope="module")
def full(cell, tmp_path_factory):
    """The cell's inputs at full size, for one seed."""
    return traffic.make_inputs(cell.traffic, cell.config, 2**31 + 4321,
                               str(tmp_path_factory.mktemp("ecoli25x")))


def test_manifest_entries(cell):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    entry = {c["name"]: c for c in man["configs"]}["canu-cor-mhap"]
    assert entry["reduced"] == cell.config["reduced"] == ["num-threads"]
    assert cell.workload["chips"] == 1 and cell.config["task"] == "canu"
    assert set(cell.per_layer) == set(METRICS)
    assert cell.end_to_end == ["mbases_per_s", "peak_device_gib", "setup_s"]
    # every flag is one the reference reads, at Canu's values
    s = compare.settings(cell.config["flags"])
    assert (s["num_hashes"], s["num_min_matches"], s["threshold"],
            s["idf_range"], s["filter_threshold"], s["min_olap_length"],
            s["supress_noise"], s["no_tf"]) == (768, 2, 0.73, 10, 5e-07,
                                                500, 0, False)
    assert isinstance(cell.config["flags"]["--filter-threshold"], float)
    assert set(cell.config["flag_sources"]) >= set(cell.config["flags"])


def test_blocks_of_canus_size(full):
    assert full.blocks == [(0, 6000), (6000, 12000)]
    assert full.bases == sum(map(len, full.reads)) > 100_000_000
    for b, argv in enumerate(full.setup_argvs):
        fa = os.path.join(argv[argv.index("-p") + 1], f"block{b}.fa")
        with open(fa) as f:
            assert f.read().count(">") == 6000
    assert full.job_argv[-4:-2] == ["-s", full.job_argv[-3]]
    assert full.job_argv[-3].endswith("block0.dat")


def test_filter_holds_the_repeat_and_no_chance_duplicate(full, cell):
    """A row's fraction times the genome's k-mers is its count there: at
    5e-7 of a 4.6 Mbp genome the cut lies between 2 and 3 copies, so
    the 5 kb family's k-mers (7 copies) pass and pairs met by chance do
    not."""
    _, genome = traffic.make_reads(cell.traffic, 2**31 + 4321)
    total = len(genome) - cell.traffic["filter"]["k"] + 1
    cutoff = cell.traffic["filter"]["cutoff"]
    assert 4_500_000 < total < 4_800_000
    assert 2 / total < cutoff <= 3 / total
    with open(full.filter_path) as f:
        header, *rows = f.read().splitlines()
    copies = [round(float(r.split()[1]) * total) for r in rows]
    assert min(copies) >= 3
    assert sum(c >= 7 for c in copies) >= 4_900
    assert int(header.split()[0]) == len(rows) < 10_000


@pytest.mark.parametrize("name", METRICS)
def test_metric_reads_its_span_or_nothing(name):
    mod = load_metric(name)
    span, = mod.SPANS
    resolve(span)  # the port has the function
    assert mod.read(Run(2, {span: 0.5}, {span: 4}, {}, None, "cpu")) == 250.0
    # the parent: no such function, so the span was not installed
    assert mod.read(Run(2, {}, {}, {}, None, "cpu", [span])) is None
    assert mod.read(Run(2, {}, {}, {}, None, "cpu")) is None


def test_tiny_run_is_correct_and_reads_both_metrics():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = run_cell(CELL, 2**31 + 5, 0.5, True, device="cpu", workers=0,
                     traffic_override={
                         "reads": 12, "coverage": 4.0,
                         "length": {"median": 1200, "sigma": 0.3,
                                    "min": 1000, "max": 1600},
                         "repeat": {"length": 300, "share": 0.3},
                         "filter": {"k": 16, "cutoff": 1.4e-4,
                                    "top": 10000},
                         "check": {"queries": 6}})
    finally:
        torch.set_num_threads(n)
    assert r["correct"], r["check"]
    assert set(r["metrics"]) == set(METRICS)
    assert all(v["value"] > 0 for v in r["metrics"].values())
