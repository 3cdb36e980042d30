"""The benchmark's spans: a span whose function the program no longer has
is left out, and the metrics that read it read nothing, while the other
spans and metrics still run."""

import json
import os
import shutil

import torch

from benchmark.cell import ROOT, Run, run_cell
from benchmark.spans import Spans
from benchmark import generators

GONE = "mhap_tpu_torch.pipeline.overlapper:TorchOverlapper.no_such_step"
KEPT = "benchmark.generators:quantile_lengths"


def test_missing_span_is_left_out_and_reads_null():
    orig = generators.quantile_lengths
    spans = Spans([GONE, KEPT])
    spans.install()
    try:
        assert spans.missing == [GONE]
        assert generators.quantile_lengths is not orig
        generators.quantile_lengths(4, 1400, 0.45, 500, 9000,
                                    generators.np.random.default_rng(1))
    finally:
        spans.uninstall()
    assert generators.quantile_lengths is orig
    run = Run(1, spans.seconds, spans.calls, spans.kept, None, "cpu",
              spans.missing)
    assert run.span_ms([KEPT]) > 0
    assert run.span_ms([GONE, KEPT]) is None


def test_traced_run_leaves_out_a_metric_whose_span_is_gone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    with open(root / "benchmark" / "metrics" / "gone_ms.py", "w") as f:
        f.write(f"SPANS = [{GONE!r}]\n\n\ndef read(run):\n"
                "    return run.span_ms(SPANS)\n")
    man["per_layer"].append({"name": "gone_ms", "unit": "ms",
                             "better": "lower", "source": "program_span",
                             "layer": "x", "moves": "mbases_per_s"})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(man, f)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        r = run_cell("default.self40k", 2**31 + 5, 0.5, True, device="cpu",
                     root=str(root), workers=0,
                     traffic_override={"reads": 60, "check": {"queries": 30}})
    finally:
        torch.set_num_threads(n)
    assert r["correct"], r["check"]
    assert "gone_ms" not in r["metrics"]
    assert {"load_ms", "sketch_ms", "format_ms"} <= set(r["metrics"])
