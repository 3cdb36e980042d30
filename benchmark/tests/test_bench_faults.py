"""A run with the timed path broken underneath comes out not correct; a
sound one correct.  The runs skip the look for a card and run the port on
the CPU at a tiny size, the rest of a run as it is."""

import numpy as np
import pytest
import torch

from benchmark.cell import run_cell
from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

TINY = {"reads": 60, "check": {"queries": 30}}


def half_the_queries(orig):
    def find(self, store, index, queries, q_sel, to_self):
        return orig(self, store, index, queries, q_sel[:len(q_sel) // 2],
                    to_self)
    return "_find_matches", find


def an_answer_altered(orig):
    def identity(self, out):
        score, raw, edges = orig(self, out)
        raw = raw.copy()
        raw[::7] += 1.0
        return score, raw, edges
    return "_identity_scores", identity


def no_work_done(orig):
    def find(self, store, index, queries, q_sel, to_self):
        return []
    return "_find_matches", find


def a_later_job_altered(orig):
    calls = [0]

    def identity(self, out):
        score, raw, edges = orig(self, out)
        calls[0] += 1
        if calls[0] > 2:  # the warm-up's and the first window job's pass
            raw = raw.copy()
            raw[::7] += 1.0
        return score, raw, edges
    return "_identity_scores", identity


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("fault", [None, half_the_queries,
                                   an_answer_altered, no_work_done,
                                   a_later_job_altered])
@pytest.mark.parametrize("trace", [False, True])
def test_fault_fails_the_check(monkeypatch, fault, trace):
    if fault is not None:
        name, _ = fault(None)
        monkeypatch.setattr(TorchOverlapper, name,
                            fault(getattr(TorchOverlapper, name))[1])
    # a tiny job takes about 2.5 s here: one window job, or two or more
    seconds = 3.0 if fault is a_later_job_altered else 0.5
    r = run_cell("default.self40k", 2**31 + 77, seconds, trace,
                 device="cpu", traffic_override=TINY, workers=0)
    assert r["correct"] is (fault is None), r["check"]
    if fault is a_later_job_altered:  # the first job is right, a later not
        assert r["check"]["lines_missing"]["value"] == 0
        assert r["check"]["jobs_differing"]["value"] == 1
    assert list(r)[-1] == "check" and r["failed"] == 0
    assert all(np.isfinite(m["value"]) for m in r["metrics"].values())
