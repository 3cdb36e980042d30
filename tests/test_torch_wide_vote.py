"""The port's one vote against the JAX package's wide join-vote.

From ``WIDE_STORE_MIN`` = 65,535 store rows on, ``TpuOverlapper`` leaves
its narrow vote for the join-once wide vote (``index/joinvote.py``,
``_find_matches_wide``).  The port keeps its one sorted-postings vote
(``index/postings.py``) at every size.  Here the JAX side is forced onto
the wide route as its own tests force it (``device_vote = True``,
``WIDE_STORE_MIN = 10``; tests/test_joinvote.py), strict (no deferred
sketch flags, so its stats count each run once), at the narrow widths of
tests/test_torch_pipeline.py, and ``TorchOverlapper(device="cpu")`` must
give the same line set and integer stats on the self, query and
repeat-heavy inputs of tests/test_joinvote.py.  A spy pins that the wide
route ran (and, on the repeat-heavy input, the JAX direct-vote
fallback for deep posting runs, which the port does not have).

The port's vote is also held against a numpy count of equal slot values
on a synthetic store of 70,000 rows, every row a query, so that both
query and candidate rows pass 16 bits, at ``HIT_BUDGET`` and at a budget
below the hits of one query.
"""

import numpy as np
import pytest
import torch

import bench as B
from mhap_tpu.pipeline.overlapper import TpuOverlapper
from mhap_tpu_torch.index import postings
from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

torch.set_num_threads(1)

CFG = dict(num_hashes=128, ordered_sketch_size=512, num_min_matches=2)
STATS = ("matches_processed", "sequences_searched", "elements_processed",
         "sequences_hit", "sequences_fully_compared")


@pytest.fixture(scope="module")
def jwide():
    """One forced-wide strict JAX overlapper (its programs compile once),
    with spies counting its wide and direct-vote calls."""
    ov = TpuOverlapper(CFG)
    ov.device_vote = True
    ov.WIDE_STORE_MIN = 10
    ov._defer_flags = False
    calls = {"wide": 0, "direct": 0}
    for name, attr in (("wide", "_find_matches_wide"),
                       ("direct", "_find_matches_direct")):
        orig = getattr(ov, attr)

        def spy(*a, _orig=orig, _name=name, **k):
            calls[_name] += 1
            return _orig(*a, **k)

        setattr(ov, attr, spy)
    return ov, calls


def run_both(jwide, method, *args):
    """(JAX lines, JAX stats of this run, JAX spy counts of this run,
    port lines, port stats)."""
    jov, calls = jwide
    before = {k: jov.stats[k] for k in STATS}
    seen = dict(calls)
    jlines = getattr(jov, method)(*args)
    jstats = {k: jov.stats[k] - before[k] for k in STATS}
    ran = {k: calls[k] - seen[k] for k in calls}
    tov = TorchOverlapper(CFG, device="cpu")
    tlines = getattr(tov, method)(*args)
    return jlines, jstats, ran, tlines, {k: tov.stats[k] for k in STATS}


def repeat_heavy_reads():
    """tests/test_joinvote.py's repeat-heavy input: 220 reads of 2.9 kb
    from a 16 kb genome holding 12 copies of a 900 bp repeat."""
    genome = B.repeat_seeded_genome(16000, seed=9, repeat_len=900,
                                    n_copies=12)
    reads, _, _ = B.make_reads_placed(220, seed=9, lognormal=False,
                                      genome=genome, genome_len=16000)
    return reads


def test_self_equals_jax_wide(jwide):
    reads = B.make_reads(n_reads=260, read_len=1000, genome_len=22000,
                         seed=5)
    jlines, jstats, ran, tlines, tstats = run_both(jwide, "overlap_self",
                                                   reads)
    assert ran["wide"] > 0
    assert tlines == jlines and len(tlines) > 1000
    assert tstats == jstats


def test_query_equals_jax_wide(jwide):
    reads = B.make_reads(n_reads=200, read_len=1000, genome_len=22000,
                         seed=6)
    jlines, jstats, ran, tlines, tstats = run_both(
        jwide, "overlap_query", reads[:140], reads[140:])
    assert ran["wide"] > 0
    assert tlines == jlines and len(tlines) > 500
    assert tstats == jstats


def test_repeat_heavy_equals_jax_wide(jwide):
    """Deep posting runs: the JAX wide vote gathers residuals and hands
    its monster queries to the direct vote; the port's one vote, with no
    cap and no fallback, gives the same pairs and stats."""
    jlines, jstats, ran, tlines, tstats = run_both(jwide, "overlap_self",
                                                   repeat_heavy_reads())
    assert ran["wide"] > 0 and ran["direct"] > 0
    assert tlines == jlines and len(tlines) > 1000
    assert tstats == jstats


# the synthetic store: N rows x H slots of random values from a range wide
# enough that chance equalities are rare, with planted families
N_ROWS, N_SLOTS, MIN_MATCHES = 70_000, 16, 3
SMALL_BUDGET = 1000


@pytest.fixture(scope="module")
def synthetic_store():
    """[N_ROWS, N_SLOTS] int32 values with (a) 3,000 families of 2-6 rows,
    drawn over the whole store, each sharing values in 2-8 slots, and (b)
    in three slots a deep run of 1,200-1,500 rows (more hits than
    SMALL_BUDGET for each of its rows) sharing one value."""
    rng = np.random.default_rng(2024)
    mh = rng.integers(-(1 << 31), (1 << 31) - 1, (N_ROWS, N_SLOTS),
                      dtype=np.int64).astype(np.int32)
    for _ in range(3000):
        rows = rng.choice(N_ROWS, rng.integers(2, 7), replace=False)
        slots = rng.choice(N_SLOTS, rng.integers(2, 9), replace=False)
        mh[np.ix_(rows, slots)] = rng.integers(0, 1 << 30, len(slots))
    for slot in (1, 7, 12):
        rows = rng.choice(N_ROWS, rng.integers(1200, 1501), replace=False)
        mh[rows, slot] = slot
    return mh


def numpy_votes(mh: np.ndarray):
    """Every store row as a query against every store row: ({(q, c) with
    at least MIN_MATCHES equal slots}, hits, distinct pairs), counted by
    grouping each slot's equal values in numpy."""
    n = len(mh)
    keys = []
    for h in range(mh.shape[1]):
        order = np.argsort(mh[:, h], kind="stable")
        v = mh[order, h]
        starts = np.flatnonzero(np.r_[True, v[1:] != v[:-1]])
        sizes = np.diff(np.r_[starts, n])
        for s, g in zip(starts[sizes > 1], sizes[sizes > 1]):
            grp = order[s:s + g].astype(np.int64)
            keys.append((grp[:, None] * n + grp[None, :]).ravel())
        single = order[starts[sizes == 1]].astype(np.int64)
        keys.append(single * n + single)  # a row hits itself
    ukey, votes = np.unique(np.concatenate(keys), return_counts=True)
    keep = ukey[votes >= MIN_MATCHES]
    return set(zip((keep // n).tolist(), (keep % n).tolist())), \
        int(votes.sum()), len(ukey)


@pytest.fixture(scope="module")
def numpy_count(synthetic_store):
    return numpy_votes(synthetic_store)


@pytest.mark.parametrize("budget", [postings.HIT_BUDGET, SMALL_BUDGET])
def test_vote_past_16_bits_matches_numpy(monkeypatch, synthetic_store,
                                         numpy_count, budget):
    monkeypatch.setattr(postings, "HIT_BUDGET", budget)
    mh = torch.from_numpy(synthetic_store)
    chunks = []
    q_idx, cand, hits, distinct = postings.vote(
        postings.build_postings(mh), mh, MIN_MATCHES, chunks)
    want, want_hits, want_distinct = numpy_count
    got = set(zip(q_idx.tolist(), cand.tolist()))
    assert got == want and len(q_idx) == len(want)
    assert hits == want_hits and distinct == want_distinct
    assert sum(chunks) == hits
    # pairs between distinct rows, with query and candidate rows past 16
    # bits
    cross = [(q, c) for q, c in want if q != c]
    assert any(q > 0xFFFF for q, _ in cross)
    assert any(c > 0xFFFF for _, c in cross)
    assert any(q > 0xFFFF and c > 0xFFFF for q, c in cross)
    assert len(cross) > 3000
    if budget == SMALL_BUDGET:
        # many chunks, and a query with more hits than the budget is a
        # chunk of its own
        assert len(chunks) > 1000 and max(chunks) > SMALL_BUDGET
    else:
        assert len(chunks) == 1
