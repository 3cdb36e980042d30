"""One short traced run of each cell on the card: exit 0, correct, and
every per-layer metric of the cell read.  Skips without a CUDA card."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.cell import ROOT, Cell


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["default.self40k",
                                  "default.ultralong4k"])
def test_cell_runs_on_the_card(cell):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        cell, "--seed", str(2**31 + 101), "--seconds", "2",
                        "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["correct"], out["check"]
    assert set(out["metrics"]) == set(Cell(cell).per_layer)
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]
