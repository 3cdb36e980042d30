"""The port's multi-GPU overlapper (``mhap_tpu_torch/parallel/sharded.py``)
on gloo ranks on the CPU, spawned through ``parallel/launch.run_ranks``.

Each world size D runs its jobs in one launch (one spawn a D).  Every
job's line set and its stats summed over the ranks equal the
single-device port's (``TorchOverlapper(device="cpu")``) on the same
input, exactly: 10 reads at D = 1, 2 and 4 (also held against the JAX
package's ``self_overlap_sharded`` on a 2-device mesh and its oracle
pipeline), about 400 reads at D = 4 with the default chunks and with the
vote's hit budget and the scorer's chunk lowered so that the ranks run
several chunks of unequal sizes, 3 reads at D = 4 (an empty rank), a
read under min_olap_length and one with no k-mer, and at D = 2
``overlap_query`` (with and without the self part) and ``-f`` at
--supress-noise 0 and 2 (the bloom) on 20 reads of 3 kb.  The small job
at D = 2 and 4 and the mid job at D = 4 are also held, lines and summed
stats, against the JAX ``ShardedOverlapper`` forced onto its wide
join-vote (``WIDE_STORE_MIN = 4``), which suppresses by header id.
"""

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from mhap_tpu.oracle import pipeline as op
from mhap_tpu.parallel import sharded as jax_sharded
from mhap_tpu_torch.index import postings
from mhap_tpu_torch.io.filter import FrequencyCounts
from mhap_tpu_torch.parallel import comm, launch
from mhap_tpu_torch.parallel.jobs import run_jobs
from mhap_tpu_torch.parallel.sharded import ShardedOverlapper, _INT_STATS
from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper
from test_filter import make_filter_file

torch.set_num_threads(1)

CFG = dict(num_hashes=64, ordered_sketch_size=256, num_min_matches=2)
WORLDS = (1, 2, 4)
# the lowered chunks of the "mid, small chunks" job
HIT_BUDGET, SCORE_CHUNK = 500, 97


def placed_reads(n: int, seed: int, glen: int):
    """tests/test_sharded.py's mid-size recipe: reads of 500-1,100 bp
    with 3 % deletions and 3 % substitutions from a random genome."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    genome = rng.integers(0, 4, glen + 1200)
    reads = []
    for _ in range(n):
        pos = int(rng.integers(0, glen))
        L = int(rng.integers(500, 1100))
        raw = genome[pos:pos + int(L * 1.15)]
        r = rng.random(len(raw))
        keep = r >= 0.03
        sub = (r >= 0.03) & (r < 0.06)
        out = np.where(sub, rng.integers(0, 4, len(raw)), raw)[keep][:L]
        reads.append(bytes(bases[out]).decode())
    return reads


@pytest.fixture(scope="module")
def small(synthetic_reads):
    _genome, reads, _pos = synthetic_reads
    return [r[:1200] for r in reads[:10]]


@pytest.fixture(scope="module")
def jobs(small, synthetic_reads):
    genome, full, _pos = synthetic_reads  # 20 reads of 3 kb
    mid = placed_reads(400, 123, 20_000)
    three = [genome[0:1100], genome[400:1500], genome[800:1900]]
    # with min_olap_length 10: a read of 5 bases is not stored, one of 14
    # has no 16-mer (the zero-ngram rule drops both strands); ids go on
    edge = full[:6] + ["ACGTA", "ACGTACGTTGCAAC"] + full[6:12]
    filt = make_filter_file(full)
    fc = {mode: FrequencyCounts(iter(filt), 1e-5, 0.9, mode, False, 3.0,
                                True, use_bloom=mode == 2) for mode in (0, 2)}
    return {
        1: {"small": dict(cfg=CFG, reads=small)},
        2: {"small": dict(cfg=CFG, reads=small),
            "query": dict(cfg=CFG, reads=full[:12], query_reads=full[12:]),
            "query, no self": dict(cfg=CFG, reads=full[:12],
                                   query_reads=full[12:], no_self=True),
            "-f mode 0": dict(cfg=CFG, reads=full, filter=fc[0]),
            "-f mode 2": dict(cfg=CFG, reads=full, filter=fc[2])},
        4: {"small": dict(cfg=CFG, reads=small),
            "mid": dict(cfg=CFG, reads=mid),
            "mid, small chunks": dict(cfg=CFG, reads=mid,
                                      hit_budget=HIT_BUDGET,
                                      score_chunk=SCORE_CHUNK),
            "3 reads": dict(cfg=CFG, reads=three),
            "short and no k-mer": dict(cfg=dict(CFG, min_olap_length=10),
                                       reads=edge)},
    }


@pytest.fixture(scope="module")
def runs(jobs):
    """{D: {job name: [rank 0's result, ...]}}, one launch a D."""
    out = {}
    for D in WORLDS:
        names = list(jobs[D])
        res = launch.run_ranks(run_jobs, D, backend="gloo",
                               devices=["cpu"] * D,
                               args=([jobs[D][n] for n in names],))
        out[D] = {n: [r[j] for r in res] for j, n in enumerate(names)}
    return out


_single: dict = {}


def single_device(job):
    """(lines, stats) of the job on the single-device port (the chunk
    sizes aside: a job's reference is computed once)."""
    key = (id(job["reads"]), id(job.get("query_reads")),
           job.get("no_self"), id(job.get("filter")), repr(job["cfg"]))
    if key not in _single:
        _single[key] = _single_device(job)
    return _single[key]


def _single_device(job):
    fc = job.get("filter")
    ov = TorchOverlapper(job["cfg"], device="cpu", kmer_filter=(
        None if fc is None else VectorFrequencyFilter(fc, "cpu")))
    if job.get("query_reads") is None:
        lines = ov.overlap_self(job["reads"])
    else:
        lines = ov.overlap_query(job["reads"], job["query_reads"],
                                 job.get("no_self", False))
    return lines, {k: ov.stats[k] for k in _INT_STATS}


CASES = [(D, name) for D, names in (
    (1, ["small"]),
    (2, ["small", "query", "query, no self", "-f mode 0", "-f mode 2"]),
    (4, ["small", "mid", "mid, small chunks", "3 reads",
         "short and no k-mer"])) for name in names]


@pytest.mark.parametrize("D,name", CASES)
def test_sharded_equals_single_device(runs, jobs, D, name):
    """Rank 0 returns the single-device line set and the other ranks
    none; the integer stats summed over ranks are the single-device
    run's."""
    want, want_stats = single_device(jobs[D][name])
    ranks = runs[D][name]
    assert ranks[0]["lines"] == want
    assert all(r["lines"] == [] for r in ranks[1:])
    assert {k: sum(r["stats"][k] for r in ranks)
            for k in _INT_STATS} == want_stats
    assert all(sum(r["launches"].values()) == 0 for r in ranks)  # CPU
    assert len(want) > 0


@pytest.fixture(scope="module")
def jax_lines(small):
    mesh = jax_sharded.make_mesh(jax.devices()[:2])
    return jax_sharded.self_overlap_sharded(mesh, dict(op.DEFAULTS, **CFG),
                                            small)


@pytest.mark.parametrize("D", WORLDS)
def test_sharded_equals_jax_sharded_and_oracle(runs, small, jax_lines, D):
    got = runs[D]["small"][0]["lines"]
    assert got == jax_lines
    assert got == op.overlap_self(small, CFG)
    assert len(got) > 0


# the JAX sharded overlapper forced onto its wide join-vote, which
# suppresses by gathered header ids (the ``hid`` mode of
# mhap_tpu/index/joinvote.py), as tests/test_sharded.py forces it
WIDE_CASES = [(2, "small"), (4, "small"), (4, "mid")]


@pytest.fixture(scope="module")
def jax_wide():
    """(D, reads) -> (lines, integer stats, wide-route calls) of a
    forced-wide JAX ShardedOverlapper on a D-device mesh, one overlapper
    a D."""
    overlappers, results = {}, {}

    def run(D, reads):
        if D not in overlappers:
            ov = jax_sharded.ShardedOverlapper(
                jax_sharded.make_mesh(jax.devices()[:D]), CFG)
            ov.WIDE_STORE_MIN = 4
            calls = [0]
            orig = ov._find_matches_wide

            def spy(*a, **k):
                calls[0] += 1
                return orig(*a, **k)

            ov._find_matches_wide = spy
            overlappers[D] = ov, calls
        key = (D, id(reads))
        if key not in results:
            ov, calls = overlappers[D]
            before = {k: ov.stats[k] for k in _INT_STATS}
            seen = calls[0]
            lines = ov.overlap_self(reads)
            results[key] = (lines, {k: ov.stats[k] - before[k]
                                    for k in _INT_STATS}, calls[0] - seen)
        return results[key]

    return run


@pytest.mark.parametrize("D,name", WIDE_CASES)
def test_sharded_equals_jax_wide_sharded(runs, jobs, jax_wide, D, name):
    """The port's ranks against the JAX sharded wide route on a mesh of
    as many devices: rank 0's line set equals it, and so do the integer
    stats summed over the ranks."""
    want, want_stats, wide_calls = jax_wide(D, jobs[D][name]["reads"])
    ranks = runs[D][name]
    assert wide_calls > 0
    assert ranks[0]["lines"] == want and len(want) > 0
    assert {k: sum(r["stats"][k] for r in ranks)
            for k in _INT_STATS} == want_stats


def test_small_chunks_are_several_and_uneven(runs, jobs, monkeypatch):
    """The lowered hit budget cuts the vote into several chunks, and the
    ranks score unequal pair counts over several scorer chunks (every
    rank runs the largest count of chunks)."""
    reads = jobs[4]["mid"]["reads"]
    ov = TorchOverlapper(CFG, device="cpu")
    store = ov.sketch_reads(reads)
    vals, sids = postings.build_postings(store.minhash)
    qT = store.minhash[torch.from_numpy(np.nonzero(store.is_fwd)[0])].t()
    per_q = (torch.searchsorted(vals, qT.contiguous(), right=True)
             - torch.searchsorted(vals, qT.contiguous())).sum(0)
    monkeypatch.setattr(postings, "HIT_BUDGET", HIT_BUDGET)
    assert len(postings.chunk_bounds(per_q.tolist())) > 20
    pairs = [r["stats"]["sequences_fully_compared"]
             for r in runs[4]["mid, small chunks"]]
    assert len(set(pairs)) > 1 and min(pairs) > 2 * SCORE_CHUNK


def test_postings_are_band_sharded(runs):
    """Each rank holds the postings of its H/D bands: 1/D of D = 1's."""
    whole = runs[1]["small"][0]["index_bytes"]
    for D in (2, 4):
        assert [r["index_bytes"] for r in runs[D]["small"]] == \
            [whole // D] * D


def test_empty_rank_joins_every_collective(runs):
    """3 reads over 4 ranks: rank 0 holds no read and still ends."""
    ranks = runs[4]["3 reads"]
    assert ranks[0]["stats"]["sequences_searched"] == 0
    assert sum(r["stats"]["sequences_searched"] for r in ranks) == 3


def test_world_size_one_in_process(small):
    """A one-rank group on an in-process store, in this process: the
    single-device lines, and total_stats equal to its stats."""
    want = TorchOverlapper(CFG, device="cpu")
    want_lines = want.overlap_self(small)
    with comm.single("gloo", "cpu") as c:
        ov = ShardedOverlapper(c, CFG)
        assert ov.overlap_self(small) == want_lines
        total = ov.total_stats()
    assert {k: total[k] for k in _INT_STATS} == \
        {k: want.stats[k] for k in _INT_STATS}


def test_num_hashes_not_divisible_raises(small):
    """num_hashes % D != 0 raises on every rank (JAX: sharded.py:118-122),
    and the launcher reports the ranks' error."""
    with pytest.raises(mp.ProcessRaisedException,
                       match="must be divisible by the world size 4"):
        launch.run_ranks(run_jobs, 4, backend="gloo", devices=["cpu"] * 4,
                         args=([dict(cfg=dict(CFG, num_hashes=66),
                                     reads=small)],))
