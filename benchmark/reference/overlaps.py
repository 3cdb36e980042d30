"""The M4 lines MHAP prints for chosen queries (reference
impl/MinHashSearch.java findMatches :149-251, impl/MatchResult.java
:98-113, impl/SequenceSketchStreamer.java's numbering and skip rules).

A store holds oriented reads, both strands of each read unless it is a
query file.  A query hits a stored strand in each sketch slot where both
hold the same value; with at least ``num_min_matches`` hits, and past the
self-search rules, the pair goes to the second-stage scorer, and an
identity of at least ``threshold`` prints one line.

Only store rows that can vote are sketched: a row's slot value is a half
of the hash of one of its own k-mers (the slot's winner), so a row none
of whose k-mers has a half equal to a sampled query's value at a slot of
that parity (low halves on even slots, high on odd) has no vote from any
sampled query.  The rows left are sketched whole.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .m4 import score_line
from .sketch import (minhash_rows, ordered_rows, reverse_complement,
                     rows_with_halves)


@dataclass
class Rows:
    """Oriented reads: header id (used by the self rules), the id printed,
    strand, length and bases, as ``SequenceSketchStreamer`` enqueues them."""
    hid: np.ndarray
    shown: list
    fwd: np.ndarray
    length: np.ndarray
    seqs: list

    @classmethod
    def of_reads(cls, reads, offset: int, do_rc: bool, min_len: int):
        """Reads numbered from 1 in file order (printed so), header ids
        shifted by ``offset``; reads shorter than min_len skipped, their
        numbers kept."""
        hid, shown, fwd, seqs = [], [], [], []
        for i, r in enumerate(reads):
            if len(r) < min_len:
                continue
            b = r.encode("ascii")
            for strand in ((True, False) if do_rc else (True,)):
                hid.append(offset + i + 1)
                shown.append(str(i + 1))
                fwd.append(strand)
                seqs.append(b if strand else reverse_complement(b))
        return cls(np.array(hid, np.int64), shown, np.array(fwd, bool),
                   np.array([len(s) for s in seqs], np.int64), seqs)


def _score_all(tasks, workers: int):
    if workers <= 1 or len(tasks) < 64:
        return [score_line(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(workers) as pool:
        return pool.map(score_line, tasks,
                        chunksize=max(1, len(tasks) // (8 * workers)))


def default_workers() -> int:
    return max(1, min(7, (os.cpu_count() or 1) - 1))


class Search:
    """A store and the searches of chosen queries against it."""

    def __init__(self, store: Rows, cfg: dict, device, weigh=None):
        self.store = store
        self.cfg = cfg
        self.device = device
        self.weigh = weigh
        self.mh = torch.zeros((len(store.hid), cfg["num_hashes"]),
                              dtype=torch.int32, device=device)
        self.have = np.zeros(len(store.hid), bool)

    def _sketch(self, seqs):
        return minhash_rows(seqs, self.cfg["kmer_size"],
                            self.cfg["num_hashes"], self.device, self.weigh)

    def candidates(self, queries: Rows, q_rows, to_self: bool):
        """(query row, store row) pairs past the vote and the self rules
        (MinHashSearch.java :161-225; min_store_length as configured)."""
        cfg = self.cfg
        st = self.store
        q_mh = self._sketch([queries.seqs[i] for i in q_rows])
        rows = rows_with_halves(st.seqs, cfg["kmer_size"], q_mh, self.device)
        need = rows[~self.have[rows]]
        if len(need):
            self.mh[torch.from_numpy(need).to(self.device)] = self._sketch(
                [st.seqs[i] for i in need])
            self.have[need] = True
        mh = self.mh[torch.from_numpy(rows).to(self.device)]
        msl = cfg["min_store_length"]
        pairs = []
        for j, qi in enumerate(q_rows):
            votes = (mh == q_mh[j]).sum(dim=1)
            hit = torch.nonzero(votes >= cfg["num_min_matches"]).squeeze(1)
            for c in rows[hit.cpu().numpy()].tolist():
                q_hid, c_hid = queries.hid[qi], st.hid[c]
                q_len, c_len = queries.length[qi], st.length[c]
                if to_self and c_hid == q_hid:
                    continue
                if c_len < msl and q_len < msl:
                    continue
                if (to_self and c_hid > q_hid and c_len >= msl
                        and q_len >= msl):
                    continue
                if to_self and c_len < msl and q_len >= msl:
                    continue
                pairs.append((qi, c))
        return pairs

    def lines(self, queries: Rows, q_rows, to_self: bool, f32=False,
              workers: int = 0) -> list:
        """The M4 lines of queries.rows[q_rows] searched against the store
        (float32 identity with ``f32``: the control)."""
        pairs = self.candidates(queries, q_rows, to_self)
        cfg = self.cfg
        qs = sorted({q for q, _ in pairs})
        cs = sorted({c for _, c in pairs})
        k2, S = cfg["ordered_kmer_size"], cfg["ordered_sketch_size"]
        q_ord = dict(zip(qs, ordered_rows([queries.seqs[i] for i in qs],
                                          k2, S, self.device)))
        c_ord = dict(zip(cs, ordered_rows([self.store.seqs[i] for i in cs],
                                          k2, S, self.device)))

        def side(rows, i, o):
            return (o[0], o[1], int(rows.length[i]), bool(rows.fwd[i]),
                    rows.shown[i])

        tasks = [(side(queries, q, q_ord[q]), side(self.store, c, c_ord[c]),
                  cfg, f32) for q, c in pairs]
        t0 = time.perf_counter()
        out = [ln for ln in _score_all(tasks, workers) if ln is not None]
        print(f"reference: {len(q_rows)} queries, {int(self.have.sum())} "
              f"store rows sketched, {len(pairs)} pairs scored in "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr,
              flush=True)
        return out
