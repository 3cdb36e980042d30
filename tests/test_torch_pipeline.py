"""The port's slice end to end on the CPU against ``TpuOverlapper``.

``TorchOverlapper(CFG, device="cpu")`` (kernels' plain versions) and the
JAX ``TpuOverlapper(CFG)`` see the same reads: the conftest
``synthetic_reads`` fixture plus a read with a tandem repeat (weighted
kernel path) and one with N bases.  Store columns must be bit-equal, line
sets and search stats equal.  One strict JAX overlapper (no deferred
sketch flags, so each run is one pass over the reads) serves every test,
so its compiled programs are reused; the repeat weights stay within its
in-kernel rung for the same reason (tests/test_torch_ops.py covers
weights up to 100 and the smoke run ~200).
"""

import numpy as np
import pytest
import torch

from mhap_tpu.pipeline.overlapper import TpuOverlapper
from mhap_tpu_torch.cli.main import main as cli_main, run_overlap
from mhap_tpu_torch.cli.options import build_options, options_to_cfg
from mhap_tpu_torch.io.filter import FrequencyCounts
from mhap_tpu_torch.index import postings
from mhap_tpu_torch.ops.minhash_kernels import (min_reduce_w1,
                                                weighted_min_reduce)
from mhap_tpu_torch.ops.scorer_kernels import score_pairs
from mhap_tpu_torch.pipeline.convert import store_from_jax
from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

# one intra-op thread: the plain kernels run many small tensor ops,
# whose thread pools stall for seconds each when test processes
# share the cores
torch.set_num_threads(1)

CFG = dict(num_hashes=128, ordered_sketch_size=512, num_min_matches=2)
STATS = ("matches_processed", "sequences_searched", "elements_processed",
         "sequences_hit", "sequences_fully_compared")


@pytest.fixture(scope="module")
def jov():
    ov = TpuOverlapper(CFG, pair_chunk=64)
    ov._defer_flags = False
    return ov


@pytest.fixture(scope="module")
def reads(synthetic_reads):
    _genome, rs, _pos = synthetic_reads
    rs = list(rs[:14])
    rs[3] = rs[3][:1000] + "NNNNN" + rs[3][1000:]            # N bases
    rs[5] = rs[5][:1500] + "ACGTTGCA" * 4 + rs[5][1500:]     # weights 2-3
    rs[7] = rs[7][:900] + rs[7][600:700] + rs[7][900:]        # 100 bp dup
    rs[6] = rs[6][:40] + rs[6][40:640].lower() + rs[6][640:]  # lower case
    rs.append("ACGT" * 10)  # shorter than min_olap_length: dropped
    return rs


@pytest.fixture(scope="module")
def jax_run(jov, reads):
    lines = jov.overlap_self(reads)
    stats = dict(jov.stats)
    return stats, lines, jov.sketch_reads(reads)


@pytest.fixture(scope="module")
def torch_run(reads):
    ov = TorchOverlapper(CFG, device="cpu")
    lines = ov.overlap_self(reads)
    store = ov.sketch_reads(reads)
    assert weighted_min_reduce.launches == 0  # CPU: plain versions only
    return ov, lines, store


@pytest.mark.parametrize("col", ["header_id", "is_fwd", "length", "minhash",
                                 "ordered_h", "ordered_p", "ordered_m",
                                 "num_kmers"])
def test_store_columns_bit_equal(jax_run, torch_run, col):
    js, ts = jax_run[2], torch_run[2]
    if col in ("header_id", "is_fwd", "length"):
        want, got = getattr(js, col), getattr(ts, col)
    else:
        want, got = np.asarray(js.dev(col)), ts.host(col)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_overlap_self_lines_and_stats(jax_run, torch_run):
    jstats, jlines, _ = jax_run
    tov, tlines, _ = torch_run
    assert tlines == jlines
    assert len(tlines) > 5
    for key in STATS:
        assert tov.stats[key] == jstats[key], key
    assert tov.slow_pair_count == 0


def test_overlap_query_lines(jov, reads):
    box, queries = reads[:8], reads[8:14]
    want = jov.overlap_query(box, queries)
    got = TorchOverlapper(CFG, device="cpu").overlap_query(box, queries)
    assert got == want and len(got) > 0


def test_headers_mode(jov, reads):
    headers = [f"read/{i}/0_{len(r)}" for i, r in enumerate(reads[:6])]
    want = jov.overlap_self(reads[:6], headers=headers)
    got = TorchOverlapper(CFG, device="cpu").overlap_self(reads[:6],
                                                          headers=headers)
    assert got == want and got


def test_store_from_jax_vote_and_score(jax_run):
    """JAX sketches carried across: the port's vote + scorer alone must
    reproduce the JAX line set."""
    _, jlines, js = jax_run
    store = store_from_jax(
        js.header_id, js.is_fwd, js.length,
        *[np.asarray(js.dev(c)) for c in ("minhash", "ordered_h",
                                          "ordered_p", "ordered_m",
                                          "num_kmers")],
        headers=js.headers, device="cpu")
    ov = TorchOverlapper(CFG, device="cpu")
    lines = ov._find_matches(store, ov._build_index(store), store,
                             np.nonzero(store.is_fwd)[0], True)
    assert sorted(lines) == jlines


@pytest.mark.parametrize("budget", [postings.HIT_BUDGET, 7])
def test_vote_chunks_match_brute_force(monkeypatch, budget):
    """The vote, in one chunk and cut into many by a tiny hit budget, equals
    a brute-force count of equal slot values (MinHashSearch.java:161-225):
    candidate pairs, hits and distinct pairs."""
    monkeypatch.setattr(postings, "HIT_BUDGET", budget)
    rng = np.random.default_rng(5)
    store = rng.integers(0, 6, (40, 16)).astype(np.int32)
    query = rng.integers(0, 6, (25, 16)).astype(np.int32)
    q_idx, cand, hits, distinct = postings.vote(
        postings.build_postings(torch.from_numpy(store)),
        torch.from_numpy(query), 4)
    votes = (query[:, None, :] == store[None, :, :]).sum(2)  # [Q, N]
    want = set(zip(*np.nonzero(votes >= 4)))
    assert set(zip(q_idx.tolist(), cand.tolist())) == want
    assert len(q_idx) == len(want) > 0
    assert hits == votes.sum() and distinct == (votes > 0).sum()


def test_cli_self_run_gives_jax_lines(jax_run, reads, tmp_path, capsys):
    """The CLI's self run (-s reads.fa at CFG) on a CPU overlapper prints
    the JAX line set, and so does -s of the .dat that -p writes from the
    same file, and so does --backend sharded at world size 1."""
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    argv = ["-s", str(fa), "--num-hashes", "128", "--ordered-sketch-size",
            "512", "--num-min-matches", "2"]
    o = build_options()
    assert o.process(argv)
    run_overlap(o, TorchOverlapper(options_to_cfg(o), device="cpu"))
    assert capsys.readouterr().out.splitlines() == jax_run[1]
    assert cli_main(["-p", str(fa), "-q", str(tmp_path)] + argv[2:],
                    device="cpu") == 0
    assert capsys.readouterr().out == ""
    assert cli_main(["-s", str(tmp_path / "reads.dat")] + argv[2:],
                    device="cpu") == 0
    assert capsys.readouterr().out.splitlines() == jax_run[1]
    assert cli_main(argv + ["--backend", "sharded"], device="cpu") == 0
    assert capsys.readouterr().out.splitlines() == jax_run[1]


def test_no_kernel_launch_on_cpu(reads):
    before = (min_reduce_w1.launches, weighted_min_reduce.launches,
              score_pairs.launches)
    TorchOverlapper(CFG, device="cpu").overlap_self(reads[:4])
    assert (min_reduce_w1.launches, weighted_min_reduce.launches,
            score_pairs.launches) == before


def test_unported_paths_raise(reads, tmp_path):
    """Every path is ported now: the filter reader takes --supress-noise
    1/2, and the CLI .dat input; only --backend oracle refuses a .dat,
    as the JAX CLI's does."""
    for ru in (1, 2):
        fc = FrequencyCounts(["1 1", "ACGTACGTACGTACGT 0.1"], 1e-5, 0.9, ru,
                             False, 3.0, True)
        assert fc.remove_unique == ru and fc.valid.numel() == 1
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads[:4])))
    assert cli_main(["-p", str(fa), "-q", str(tmp_path), "--num-hashes",
                     "128"], device="cpu") == 0
    assert (tmp_path / "reads.dat").stat().st_size > 0
    with pytest.raises(SystemExit, match="requires the device backend"):
        cli_main(["-s", str(tmp_path / "reads.dat"), "--backend", "oracle"])
    assert TorchOverlapper(CFG, device="cpu").device == torch.device("cpu")
