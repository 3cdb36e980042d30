"""The manifest, and the harness finding a cell's files by name: a
configuration, traffic mix and metric added as files in a copy are found
without an edit to any file there."""

import json
import os
import re
import shutil

import pytest

from benchmark.cell import ROOT, Cell, load_metric

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_manifest_keys_and_names(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert 1 <= manifest["run_seconds"] <= 51
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and len(c["source"]) <= 200
        assert c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["name"] == c["name"]
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(ROOT, "benchmark", "traffic",
                                           w["traffic"] + ".json"))
    names = [m["name"] for m in manifest["end_to_end"] +
             manifest["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in manifest["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in manifest["end_to_end"]}
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        mod = load_metric(m["name"])
        assert callable(mod.read) and isinstance(mod.SPANS, list)
    assert len(json.dumps(manifest)) < 64 * 1024


@pytest.mark.parametrize("cell", ["default.self40k",
                                  "default.ultralong4k"])
def test_cells_resolve(cell):
    c = Cell(cell)
    assert c.config["task"] in ("self", "canu")
    assert "setup_s" in c.end_to_end and len(c.end_to_end) >= 2
    assert c.per_layer


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    with open(root / "benchmark" / "configs" / "new-cfg.json", "w") as f:
        json.dump({"name": "new-cfg", "task": "self", "flags": {"-k": 14}},
                  f)
    with open(root / "benchmark" / "traffic" / "newmix.json", "w") as f:
        json.dump({"reads": 10, "coverage": 5.0}, f)
    with open(root / "benchmark" / "metrics" / "new_metric.py", "w") as f:
        f.write("SPANS = []\n\n\ndef read(run):\n    return 42.0\n")
    man["configs"].append({"name": "new-cfg", "source": "x",
                           "file": "benchmark/configs/new-cfg.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "new.cell", "config": "new-cfg",
                             "traffic": "newmix", "chips": 1, "why": "x"})
    man["per_layer"].append({"name": "new_metric", "unit": "ms",
                             "better": "lower", "source": "program_span",
                             "layer": "x", "moves": "mbases_per_s",
                             "workloads": ["new.cell"]})
    with open(root / "BENCHMARK.json", "w") as f:
        json.dump(man, f)
    c = Cell("new.cell", str(root))
    assert c.config["flags"] == {"-k": 14}
    assert c.traffic == {"reads": 10, "coverage": 5.0}
    assert list(c.per_layer) == ["new_metric"]
    assert c.per_layer["new_metric"].read(None) == 42.0
    assert "new_metric" not in Cell("default.self40k", str(root)).per_layer
