"""End-to-end self/query overlapper on PyTorch (counterpart of
mhap_tpu/pipeline/overlapper.py, ``TpuOverlapper``).

  reads -> upper-cased ASCII rows, sorted by length and cut into chunks of
    at most ROWS rows and CELLS row x width cells, each as wide as its
    longest read (one host->device copy per chunk; both strands as bytes,
    the reverse complement made on the host)
    -> murmur3_128 16-mer hashes (ops/murmur3.py)
    -> weighted-MinHash min-reduce: without a filter, rows with no
       repeated k-mer through kernel 1 (min_reduce_w1) and rows with one
       through sort_and_count and kernel 2 (weighted_min_reduce) at their
       exact counts; with a k-mer filter (pipeline/freqfilter.py), every
       row through kernel 2 at its tf-idf or legacy weights; under
       --supress-noise 1 the k-mers outside the filter file are dropped
       first, at every repeat_weight
    -> murmur3_32 12-mers + bottom-k sort (ops/bottomk.py)
  -> SketchStore: columns stay on the device
  -> exact sorted-postings vote (index/postings.py) + suppression rules
  -> kernel 3 (score_pairs) on every candidate pair, gathering its rows
     from the store by index
  -> host float64 identity per distinct (inter, k) + M4 lines.

The emitted line set equals ``TpuOverlapper``'s.  Reads of any length take
the same path: a read of a megabase is one row of its own chunk (the JAX
package streams reads of 131,072 bases or more through a windowed
sketcher, ``_sketch_long``, whose store equals the dense one).
"""

from __future__ import annotations

import math
import time
from functools import partial

import numpy as np
import torch

from ..device import resolve_device
from ..index import postings as _postings
from ..io.formats import M4Lines
from ..ops import bottomk as _bottomk
from ..ops import minhash as _minhash
from ..ops import murmur3 as _murmur3
from ..ops.minhash_kernels import min_reduce_w1, weighted_min_reduce
from ..ops.scorer import COLS as SCORE_COLS
from ..ops.scorer import N_COLS
from ..ops.scorer_kernels import score_pairs as _score_pairs_kernel
from ..utils import trace
from ..utils.native import m4_format

DEFAULTS = dict(
    kmer_size=16,
    num_hashes=512,
    num_min_matches=3,
    threshold=0.78,
    ordered_kmer_size=12,
    ordered_sketch_size=1536,
    max_shift=0.2,
    min_store_length=0,
    min_olap_length=116,
    repeat_weight=0.9,
)

_RC_TABLE = np.arange(256, dtype=np.uint8)
for _a, _b in [("A", "T"), ("C", "G"), ("M", "K"), ("R", "Y"), ("W", "W"),
               ("S", "S"), ("V", "B"), ("H", "D"), ("N", "N")]:
    _RC_TABLE[ord(_a)] = ord(_b)
    _RC_TABLE[ord(_b)] = ord(_a)


def _rc_codes(codes: np.ndarray) -> np.ndarray:
    """Reverse complement of ASCII codes (utils/Utils.java rc(), IUPAC)."""
    return _RC_TABLE[codes[::-1]]


def jaccard_to_identity(score: float, kmer_size: int) -> float:
    """Mash distance -> identity (BottomOverlapSketch.jaccardToIdentity
    :391-395), as scalar math.log/exp: numpy's SIMD exp/log can be 1 ulp
    off Java's."""
    if score <= 0.0:
        return 0.0
    d = -1.0 / kmer_size * math.log(2.0 * score / (1.0 + score))
    return math.exp(-d)


def score_columns(parts) -> dict:
    """Blocks of scorer output [t, 16] -> one host array a column of
    ``ops/scorer.COLS``."""
    out = np.concatenate(parts) if parts else np.zeros((0, N_COLS), np.int32)
    return {name: out[:, j] for j, name in enumerate(SCORE_COLS)}


class SketchStore:
    """Dense sketch columns for a set of oriented reads
    (impl/SequenceSketch.java's bundle, as columns).

    Host numpy: header_id [N] int64, is_fwd [N] bool, length [N] int32,
    headers.  Device tensors: minhash [N, H], ordered_h/ordered_p [N, S],
    ordered_m [N] (valid entries) and num_kmers [N], all int32."""

    def __init__(self, header_id, is_fwd, length, minhash, ordered_h,
                 ordered_p, ordered_m, num_kmers, headers=None):
        self.header_id = np.asarray(header_id, dtype=np.int64)
        self.is_fwd = np.asarray(is_fwd, dtype=bool)
        self.length = np.asarray(length, dtype=np.int32)
        self.headers = (list(headers) if headers is not None
                        else [None] * len(self.header_id))
        self.minhash = minhash
        self.ordered_h = ordered_h
        self.ordered_p = ordered_p
        self.ordered_m = ordered_m
        self.num_kmers = num_kmers

    def __len__(self):
        return len(self.header_id)

    @property
    def n_real(self) -> int:
        return int(np.count_nonzero(self.header_id))

    def display(self, i: int) -> str:
        h = self.headers[i]
        return h if h is not None else str(int(self.header_id[i]))

    def host(self, name: str) -> np.ndarray:
        return getattr(self, name).cpu().numpy()

    def scorer_cols(self):
        return (self.ordered_h, self.ordered_p, self.ordered_m,
                self.num_kmers)


class TorchOverlapper:
    """Single-GPU overlapper; ``device="cpu"`` runs the kernels' plain
    versions (tests).  ``kmer_filter`` is a
    ``pipeline.freqfilter.VectorFrequencyFilter`` on the same device."""

    ROWS = 1024                  # rows per sketch chunk
    # row x width cells per sketch chunk: 2^24 holds the widest chunk of
    # lognormal10k (1,024 x 9,024) whole and cuts a chunk of 400 kb reads
    # to 41 rows; the murmur3 and sort temporaries scale with it
    CELLS = 1 << 24
    SCORE_CHUNK = 1 << 20        # pairs per scorer launch

    def __init__(self, cfg=None, device="cuda", kmer_filter=None):
        self.cfg = dict(DEFAULTS)
        if cfg:
            self.cfg.update(cfg)
        self.device = resolve_device(device)
        self.kmer_filter = kmer_filter
        if kmer_filter is not None and kmer_filter.device != self.device:
            raise ValueError(f"kmer_filter lives on {kmer_filter.device}, "
                             f"the overlapper on {self.device}")
        rw = float(self.cfg["repeat_weight"])
        # repeat_weight >= 1 weights by count: the plain path
        # (mhap_tpu/pipeline/overlapper.py:873-876), after mode 1's keep
        # mask, which holds at every weight mode (the JAX package's host
        # flow, :869-876)
        self._weights = (partial(kmer_filter.weights, repeat_weight=rw)
                         if kmer_filter is not None and rw < 1.0 else None)
        self._keep = (kmer_filter.member if kmer_filter is not None
                      and kmer_filter.remove_unique == 1 else None)
        self.slow_pair_count = 0  # lanes the scorer escalated: always 0
        self.largest_hit_chunk = 0  # most hits the vote expanded at once
        self.stats = dict(matches_processed=0, sequences_searched=0,
                          elements_processed=0, sequences_hit=0,
                          sequences_fully_compared=0,
                          minhash_search_time=0.0)
        # M4 lines formatted in C and by Python's %-format: the tracer's
        # job counters, kept out of ``stats`` (MhapMain's)
        self.m4_counts = dict(m4_lines_native=0, m4_lines_python=0)

    # ---------------- sketching ----------------

    def _sketch_chunk(self, codes: np.ndarray, lens: np.ndarray):
        """[R, W] uint8 rows -> (minhash, ordered_h, ordered_p, ordered_m,
        n_active) device tensors (_sketch_core, overlapper.py:247);
        n_active counts the k-mers the min-reduce took in each row."""
        cfg = self.cfg
        k1, k2 = cfg["kmer_size"], cfg["ordered_kmer_size"]
        H, S = cfg["num_hashes"], cfg["ordered_sketch_size"]
        dev = self.device
        with trace.span("sketch.wait"):
            seq = torch.from_numpy(codes).to(dev)
            ln = torch.from_numpy(lens).to(dev).to(torch.int64)[:, None]
        R, W = codes.shape
        valid1 = torch.arange(W - k1 + 1, device=dev)[None, :] < ln - k1 + 1
        h = _murmur3.kmer_hashes_128(seq, k1)
        if self._keep is not None:  # keepKmer: dropped before counting
            valid1 = valid1 & self._keep(h)
        if self._weights is not None:
            mh, n_active = _minhash.minhash_filtered_rows(
                h, valid1, self._weights, H, weighted_min_reduce)
        else:
            n_active = valid1.sum(dim=1)
            # rows with a repeated k-mer need the weighted kernel; the
            # flags come to the host here, synchronously
            flags = _minhash.dup_rows(h, valid1)
            with trace.span("sketch.wait"):
                dup = flags.cpu().numpy()
            if not dup.any():
                mh = min_reduce_w1(h, valid1, H)
            else:
                mh = torch.empty((R, H), dtype=torch.int32, device=dev)
                with trace.span("sketch.wait"):
                    plain = torch.from_numpy(np.nonzero(~dup)[0]).to(dev)
                    rep = torch.from_numpy(np.nonzero(dup)[0]).to(dev)
                if plain.numel():
                    mh[plain] = min_reduce_w1(h[plain], valid1[plain], H)
                mh[rep] = _minhash.minhash_weighted_rows(
                    h[rep], valid1[rep], H, weighted_min_reduce)
        valid2 = torch.arange(W - k2 + 1, device=dev)[None, :] < ln - k2 + 1
        h32 = _murmur3.kmer_hashes_32(seq, k2)
        oh, op, om = _bottomk.bottom_sketch(h32, valid2, S)
        return mh, oh, op, om, n_active

    def sketch_reads(self, reads: list[str], headers=None, offset: int = 0,
                     do_rc: bool = True) -> SketchStore:
        """Sketch fwd (+rc) of every read with the reference's skip rules
        (SequenceSketchStreamer.java:123-177): reads shorter than
        min_olap_length are dropped and ids keep counting; a forward strand
        with no k-mer in its MinHash drops the read, such an rc strand
        drops the rc entry (overlapper.py:897-921).  Under a filter that
        counts only kept k-mers of weight > 0 (a legacy run drops a read
        whose k-mers are all file k-mers, a mode-1 run one with no k-mer
        in the file)."""
        cfg = self.cfg
        k1, k2 = cfg["kmer_size"], cfg["ordered_kmer_size"]
        H, S = cfg["num_hashes"], cfg["ordered_sketch_size"]
        dev = self.device
        with trace.span("sketch"):
            with trace.span("sketch.prepare"):
                entries = []  # (header_id, is_fwd, header, codes)
                for i, r in enumerate(reads):
                    if len(r) < cfg["min_olap_length"]:
                        continue
                    hid = i + 1 + offset
                    hdr = headers[i] if headers is not None else None
                    codes = np.frombuffer(r.upper().encode("ascii"),
                                          dtype=np.uint8)
                    entries.append((hid, True, hdr, codes))
                    if do_rc:
                        entries.append((hid, False, hdr, _rc_codes(codes)))
                lens = np.asarray([len(e[3]) for e in entries], np.int64)
            N = len(entries)
            mh = torch.empty((N, H), dtype=torch.int32, device=dev)
            oh = torch.empty((N, S), dtype=torch.int32, device=dev)
            op = torch.empty((N, S), dtype=torch.int32, device=dev)
            om = torch.empty((N,), dtype=torch.int32, device=dev)
            n_active = torch.empty((N,), dtype=torch.int64, device=dev)
            # length bucketing: sorted by length, each chunk trimmed to its
            # longest read (every [B, n] op scales with the width) and cut
            # to CELLS cells, so long reads come last in chunks of a few rows
            order = np.argsort(lens, kind="stable")

            def width(j):  # padded width of a chunk whose longest entry is j
                return max(-(-int(lens[j]) // 64) * 64, k1, k2)

            s = 0
            while s < N:
                with trace.span("sketch.chunk"):
                    R = min(self.ROWS, N - s)
                    if R * width(order[s + R - 1]) > self.CELLS:
                        # fewer rows are no wider, so R * W stays in CELLS
                        R = max(1, self.CELLS // width(order[s + R - 1]))
                    idx = order[s:s + R]
                    W = width(idx[-1])
                    with trace.span("sketch.pack"):
                        codes = np.zeros((R, W), np.uint8)
                        for r, j in enumerate(idx):
                            codes[r, :lens[j]] = entries[j][3]
                    out = self._sketch_chunk(codes,
                                             lens[idx].astype(np.int32))
                    with trace.span("sketch.wait"):
                        rows = torch.from_numpy(idx).to(dev)
                    for col, val in zip((mh, oh, op, om, n_active), out):
                        col[rows] = val
                s += R
            with trace.span("sketch.skip"):
                # zero-ngram skip rules
                with trace.span("sketch.wait"):
                    mh_valid = n_active.cpu().numpy() > 0
                keep = np.ones(N, bool)
                for j, (hid, fwd, _hdr, _c) in enumerate(entries):
                    if not mh_valid[j]:
                        keep[j] = False
                        if (fwd and do_rc and j + 1 < N
                                and entries[j + 1][0] == hid):
                            keep[j + 1] = False
                sel = np.nonzero(keep)[0]
                with trace.span("sketch.wait"):
                    sel_t = torch.from_numpy(sel).to(dev)
                nk = np.maximum(lens[sel] - k2 + 1, 0).astype(np.int32)
                cols = [c[sel_t].contiguous() for c in (mh, oh, op, om)]
                with trace.span("sketch.wait"):
                    num_kmers = torch.from_numpy(nk).to(dev)
                return SketchStore(
                    header_id=np.asarray([entries[j][0] for j in sel],
                                         np.int64),
                    is_fwd=np.asarray([entries[j][1] for j in sel], bool),
                    length=lens[sel].astype(np.int32),
                    headers=[entries[j][2] for j in sel],
                    minhash=cols[0], ordered_h=cols[1], ordered_p=cols[2],
                    ordered_m=cols[3], num_kmers=num_kmers)

    # ---------------- vote ----------------

    def _build_index(self, store: SketchStore):
        """The store's sorted postings, the index for _find_matches."""
        with trace.span("index"):
            return _postings.build_postings(store.minhash)

    # ---------------- scoring ----------------

    def _score_dispatch(self, qs: SketchStore, cs: SketchStore,
                        qi: np.ndarray, ci: np.ndarray) -> dict:
        """Kernel 3 over every pair, chunked; columns as host arrays."""
        dev, step = self.device, self.SCORE_CHUNK
        parts = []
        for s in range(0, len(qi), step):
            with trace.span("score.wait"):
                q = torch.from_numpy(qi[s:s + step]).to(dev)
                c = torch.from_numpy(ci[s:s + step]).to(dev)
            out = _score_pairs_kernel(qs.scorer_cols(), cs.scorer_cols(), q,
                                      c, float(self.cfg["max_shift"]))
            with trace.span("score.wait"):
                parts.append(out.cpu().numpy())
        return score_columns(parts)

    def _identity_scores(self, out: dict):
        """Integer scorer outputs -> (score, raw, edges) host arrays.

        The mash identity runs as scalar math.exp/log once per DISTINCT
        (inter, k): bit-identical to the oracle/Java double path (numpy's
        SIMD exp/log may differ by 1 ulp) (overlapper.py:1645)."""
        k2 = self.cfg["ordered_kmer_size"]
        base = self.cfg["ordered_sketch_size"] + 1  # k <= sketch size
        ok = out["ok"].astype(bool)
        kk = np.maximum(out["k"], 1)
        pair_key = out["inter"].astype(np.int64) * base + kk
        uniq, inv = np.unique(pair_key, return_inverse=True)
        sc_u = np.array([jaccard_to_identity(
            float(u // base) / float(u % base), k2) for u in uniq])
        score = np.where(ok, sc_u[inv], 0.0)
        raw = np.where(ok, out["valid_cnt"].astype(np.float64), 0.0)
        edges = np.zeros((len(score), 4), np.int32)
        for n, name in enumerate(("a1", "a2", "b1", "b2")):
            edges[:, n] = np.where(ok, out[name], 0)
        return score, raw, edges

    def score_pairs(self, qs: SketchStore, cs: SketchStore,
                    qi: np.ndarray, ci: np.ndarray):
        """Stage-2 scores of (qs[qi[t]], cs[ci[t]]).  Returns (score
        float64 [T], raw float64 [T], edges int32 [T, 4])."""
        with trace.span("score"):
            out = self._score_dispatch(qs, cs, qi.astype(np.int32),
                                       ci.astype(np.int32))
        self.slow_pair_count += int(out["escal"].sum())
        with trace.span("identity"):
            return self._identity_scores(out)

    # ---------------- match driving ----------------

    def _format(self, qs: SketchStore, cs: SketchStore, qi, ci, score, raw,
                edges) -> M4Lines:
        """MatchResult coordinate flips + M4 formatting (MatchResult.java;
        overlapper.py:1839): in C (``utils/native.m4_format``) unless a
        store carries header strings, then ``_format_headers``."""
        T = len(qi)
        if T == 0:
            return M4Lines()
        qi = np.asarray(qi, np.int64)
        ci = np.asarray(ci, np.int64)
        qlen = qs.length[qi].astype(np.int64)
        clen = cs.length[ci].astype(np.int64)
        qf = qs.is_fwd[qi]
        cf = cs.is_fwd[ci]
        a1, a2 = edges[:, 0].astype(np.int64), edges[:, 1].astype(np.int64)
        b1, b2 = edges[:, 2].astype(np.int64), edges[:, 3].astype(np.int64)
        fa1 = np.where(qf, a1, qlen - a2 - 1)
        fa2 = np.where(qf, a2, qlen - a1 - 1)
        fb1 = np.where(cf, b1, clen - b2 - 1)
        fb2 = np.where(cf, b2, clen - b1 - 1)
        err = 1.0 - np.minimum(np.asarray(score, np.float64), 1.0)
        raw = np.asarray(raw, np.float64)
        qrc = np.where(qf, 0, 1)
        crc = np.where(cf, 0, 1)
        if not any(qs.headers) and not any(cs.headers):
            self.m4_counts["m4_lines_native"] += T
            return M4Lines(m4_format(qs.header_id[qi], cs.header_id[ci], err,
                                     raw, qrc, fa1, fa2, qlen, crc, fb1, fb2,
                                     clen), T)
        return self._format_headers(qs, cs, qi, ci, err, raw, qrc, fa1, fa2,
                                    qlen, crc, fb1, fb2, clen)

    def _format_headers(self, qs: SketchStore, cs: SketchStore, qi, ci, err,
                        raw, qrc, fa1, fa2, qlen, crc, fb1, fb2,
                        clen) -> M4Lines:
        """``_format``'s lines with Python's %-format, for stores that
        carry header strings (``.dat`` records, ``--store-full-id``): the
        A and B ids are the reads' display names."""
        with trace.span("format.python"):
            self.m4_counts["m4_lines_python"] += len(qi)
            disp_q = [qs.display(int(q)) for q in qi]
            disp_c = [cs.display(int(c)) for c in ci]
            return M4Lines.of(
                ["%s %s %.6f %.6f %d %d %d %d %d %d %d %d" % t
                 for t in zip(disp_q, disp_c, err.tolist(), raw.tolist(),
                              qrc.tolist(), fa1.tolist(), fa2.tolist(),
                              qlen.tolist(), crc.tolist(), fb1.tolist(),
                              fb2.tolist(), clen.tolist())])

    def _vote(self, index, queries: SketchStore, q_sel: np.ndarray):
        """Pairs (position in ``q_sel``, store row) with at least
        num_min_matches votes, as host int64 arrays; adds the search
        stats."""
        self.stats["sequences_searched"] += len(q_sel)
        with trace.span("vote.wait"):
            rows = torch.from_numpy(q_sel).to(self.device)
        chunks = []
        q_idx, cand, hits_total, distinct = _postings.vote(
            index, queries.minhash[rows], self.cfg["num_min_matches"], chunks)
        self.largest_hit_chunk = max([self.largest_hit_chunk, *chunks])
        self.stats["elements_processed"] += hits_total
        self.stats["sequences_hit"] += distinct
        with trace.span("vote.wait"):
            return q_idx.cpu().numpy(), cand.cpu().numpy()

    def _candidates(self, store: SketchStore, index, queries: SketchStore,
                    q_sel: np.ndarray, to_self: bool):
        """Vote + suppression rules (MinHashSearch.java:149-251;
        overlapper.py:2583-2613): (query row, store row) pairs to score."""
        cfg = self.cfg
        t0 = time.perf_counter()
        q_sel = np.asarray(q_sel, np.int64)
        q_idx, cand = self._vote(index, queries, q_sel)
        self.stats["minhash_search_time"] += time.perf_counter() - t0
        qg = q_sel[q_idx]
        keepm = store.header_id[cand] > 0
        msl = cfg["min_store_length"]
        q_hid = queries.header_id[qg]
        c_hid = store.header_id[cand]
        q_len = queries.length[qg].astype(np.int64)
        c_len = store.length[cand].astype(np.int64)
        if to_self:
            keepm &= c_hid != q_hid
        keepm &= ~((c_len < msl) & (q_len < msl))
        if to_self:
            keepm &= ~((c_hid > q_hid) & (c_len >= msl) & (q_len >= msl))
            keepm &= ~((c_len < msl) & (q_len >= msl))
        return qg[keepm], cand[keepm]

    def _find_matches(self, store: SketchStore, index, queries: SketchStore,
                      q_sel: np.ndarray, to_self: bool) -> M4Lines:
        """Candidates, then scoring and formatting of the accepted pairs."""
        if len(q_sel) == 0:
            return M4Lines()
        with trace.span("vote"):
            qg, cand = self._candidates(store, index, queries, q_sel,
                                        to_self)
        self.stats["sequences_fully_compared"] += len(qg)
        score, raw, edges = self.score_pairs(queries, store, qg, cand)
        acc = score >= self.cfg["threshold"]
        self.stats["matches_processed"] += int(acc.sum())
        with trace.span("format"):
            return self._format(queries, store, qg[acc], cand[acc],
                                score[acc], raw[acc], edges[acc])

    # ---------------- stores and results (parallel/sharded.py splits
    # each over its ranks) ----------------

    def read_dat(self, path: str, offset: int = 0,
                 fwd_only: bool = False) -> SketchStore:
        """A ``.dat`` sketch file as a store on this overlapper's device."""
        from ..io import datstore

        with trace.span("load"):
            return datstore.read_dat(path, offset, fwd_only,
                                     self.cfg["ordered_sketch_size"],
                                     self.device)

    def whole_store(self, store: SketchStore):
        """The store whole, as ``-p`` writes it to a ``.dat`` file."""
        return store

    def _gather_lines(self, lines) -> M4Lines:
        """The run's line set (an ``M4Lines`` or a ``list[str]``),
        sorted."""
        with trace.span("sort"):
            return M4Lines.of(lines).sorted()

    def total_stats(self) -> dict:
        """The search stats of every run so far (the CLI's stats block)."""
        return dict(self.stats)

    def overlap_self(self, reads: list[str], headers=None) -> list[str]:
        """Self-overlap run; returns the sorted list of M4 lines."""
        store = self.sketch_reads(reads, headers)
        index = self._build_index(store)
        q_sel = np.nonzero(store.is_fwd)[0]
        return self._gather_lines(
            self._find_matches(store, index, store, q_sel, True)).tolist()

    def overlap_query(self, box_reads: list[str], query_reads: list[str],
                      no_self: bool = False) -> list[str]:
        """Box-vs-query run (MhapMain usage 1 with -q)."""
        box = self.sketch_reads(box_reads)
        index = self._build_index(box)
        lines = M4Lines()
        if not no_self:
            q_sel = np.nonzero(box.is_fwd)[0]
            lines += self._find_matches(box, index, box, q_sel, True)
        queries = self.sketch_reads(query_reads, offset=box.n_real // 2,
                                    do_rc=False)
        lines += self._find_matches(box, index, queries,
                                    np.arange(len(queries)), False)
        return self._gather_lines(lines).tolist()
