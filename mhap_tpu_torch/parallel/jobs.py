"""Rank workers for ``parallel/launch.run_ranks``: the sharded path as the
CPU and card tests and ``scripts/sharded_check.py`` drive it, with what
they measure on each rank.  Module-level functions of the package,
so a spawned rank imports them without JAX."""

from __future__ import annotations

import contextlib
import io
import time

import torch

from ..index import postings as _postings
from ..ops.minhash_kernels import min_reduce_w1, weighted_min_reduce
from ..ops.scorer_kernels import score_pairs
from .sharded import ShardedOverlapper

KERNELS = {"min_reduce_w1": min_reduce_w1,
           "weighted_min_reduce": weighted_min_reduce,
           "score_pairs": score_pairs}


def run_jobs(comm, jobs: list) -> list:
    """Runs each job on a fresh ``ShardedOverlapper`` and returns, a job,
    its lines (rank 0's; [] elsewhere), its wall seconds on this rank,
    this rank's stats, kernel launches, peak device memory and postings
    bytes.  A job is a dict: ``reads``, and optionally ``cfg``,
    ``query_reads`` (then ``overlap_query``, with ``no_self``),
    ``filter`` (an ``io.filter.FrequencyCounts``), ``hit_budget`` (this
    process's ``postings.HIT_BUDGET`` for the job) and ``score_chunk``
    (the overlapper's SCORE_CHUNK)."""
    from ..pipeline.freqfilter import VectorFrequencyFilter

    cuda = comm.device.type == "cuda"
    budget = _postings.HIT_BUDGET
    out = []
    for job in jobs:
        fc = job.get("filter")
        ov = ShardedOverlapper(comm, job.get("cfg"), kmer_filter=(
            None if fc is None else VectorFrequencyFilter(fc, comm.device)))
        ov.SCORE_CHUNK = job.get("score_chunk") or ov.SCORE_CHUNK
        _postings.HIT_BUDGET = job.get("hit_budget") or budget
        for k in KERNELS.values():
            k.launches = 0
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            if job.get("query_reads") is None:
                lines = ov.overlap_self(job["reads"])
            else:
                lines = ov.overlap_query(job["reads"], job["query_reads"],
                                         job.get("no_self", False))
        finally:
            _postings.HIT_BUDGET = budget
        if cuda:
            torch.cuda.synchronize()
        out.append(dict(
            lines=lines, seconds=time.perf_counter() - t0,
            stats=dict(ov.stats),
            launches={n: k.launches for n, k in KERNELS.items()},
            peak_bytes=torch.cuda.max_memory_allocated() if cuda else None,
            index_bytes=ov.index_bytes))
    return out


def run_cli(comm, argvs: list) -> list:
    """``cli.main.main(argv)`` for each of ``argvs`` in turn on this rank
    of ``comm``: a list of (exit code, stdout)."""
    from ..cli.main import main

    runs = []
    for argv in argvs:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(argv, comm.device, comm)
        runs.append((rc, out.getvalue()))
    return runs
