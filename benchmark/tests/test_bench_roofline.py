"""The rooflines' arithmetic against counts made by hand."""

import numpy as np
import torch

from benchmark.cell import load_metric
from benchmark.peaks import PEAKS, bound_s

H100 = "NVIDIA H100 80GB HBM3"


class Ov:
    def __init__(self, kmer_filter=None):
        self.cfg = {"kmer_size": 16, "num_hashes": 512,
                    "min_olap_length": 116}
        self.kmer_filter = kmer_filter


def test_peaks_are_the_data_sheets():
    assert PEAKS[H100]["bytes_per_s"] == 3.35e12
    assert abs(PEAKS[H100]["int32_ops_per_s"] - 16.727e12) < 1e9
    assert bound_s(H100, 3.35e12, 1.0) == 1.0
    assert bound_s(H100, 1.0, 16.727e12) > 0.99
    assert bound_s("another card", 1.0, 1.0) is None


def test_minhash_work_by_hand():
    m = load_metric("minhash_roofline")
    reads = ["A" * 116, "C" * 200, "G" * 100]  # the last is too short
    nbytes, nops = m.work([((Ov(), reads), {"do_rc": True})])
    kmers = (101 + 185) * 2
    assert nbytes == kmers * 9 + 4 * 512 * 4
    assert nops == kmers * 512 * 16
    assert m.work([((Ov(), reads, None, 0, False), {})])[1] == \
        (101 + 185) * 512 * 16
    assert m.work([((Ov(kmer_filter=object()), reads), {})]) is None


class Store:
    def __init__(self, m):
        self.ordered_m = torch.tensor(m, dtype=torch.int32)


def test_score_work_by_hand():
    m = load_metric("score_roofline")
    s = Store([10, 20, 30])
    qi, ci = np.array([0, 1, 1]), np.array([2, 2, 0])
    nbytes, nops = m.work([((None, s, s, qi, ci), {})])
    m_sum = (10 + 20 + 20) + (30 + 30 + 10)
    assert nops == 2 * m_sum * 8
    assert nbytes == (60 * 8 + 3 * 8) + 3 * 72
    q = Store([5, 7])
    nbytes, _ = m.work([((None, q, s, np.array([0, 0]), np.array([1, 2])),
                         {})])
    assert nbytes == (5 * 8 + 8) + (50 * 8 + 16) + 2 * 72


class FakeTrace:
    window_s = 2.0
    busy_s = 0.5

    def kernel_seconds(self, prefixes):
        return 0.004


class FakeRun:
    card = H100
    trace = FakeTrace()

    def __init__(self, kept):
        self._kept = kept

    def kept(self, name):
        return self._kept


def test_shares_in_percent():
    idle = load_metric("device_idle_share")
    assert idle.read(FakeRun([])) == 75.0
    m = load_metric("minhash_roofline")
    calls = [((Ov(), ["A" * 1016]), {})]
    nbytes, nops = m.work(calls)
    want = 100 * max(nbytes / 3.35e12, nops / (132 * 64 * 1980e6)) / 0.004
    assert abs(m.read(FakeRun(calls)) - want) < 1e-9
    assert m.read(FakeRun([])) is None
