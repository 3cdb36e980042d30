"""End-to-end oracle of a full MHAP overlap run (the golden generator;
the port's copy of mhap_tpu/oracle/pipeline.py, behind ``--backend
oracle``).

Parity targets: impl/MinHashSearch.java (index + vote + suppression rules),
impl/AbstractMatchSearch.java (self / query drivers), impl/MatchResult.java
(coordinate flips + formatting), impl/SequenceSketchStreamer.java (fwd+rev
enqueue, min-olap-length and zero-ngram skip rules), main/MhapMain.java
(defaults).

The output is a *set* of M4-style lines; the reference's line order depends
on thread scheduling and hash-map iteration and is not part of parity.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import scorer as _scorer
from . import sketch as _sketch
from .seq import reverse_complement

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


@dataclass
class OracleSketch:
    """Per-oriented-read sketch bundle (impl/SequenceSketch.java)."""
    header_id: int
    is_fwd: bool
    header: str | None
    length: int                  # actual sequence length
    min_hashes: np.ndarray       # int32 [num_hashes]
    ordered: np.ndarray          # int32 [m, 2] (hash, pos)
    num_kmers: int               # ordered-sketch seqLength field

    @property
    def key(self):
        return (self.header_id, self.is_fwd)

    def display_header(self) -> str:
        return self.header if self.header is not None else str(self.header_id)


def sketch_read(seq: str, header_id: int, is_fwd: bool, header, cfg,
                kmer_filter=None) -> OracleSketch:
    mh = _sketch.minhash_sketch(seq, cfg["kmer_size"], cfg["num_hashes"],
                                kmer_filter, cfg["repeat_weight"])
    ordered, nk = _sketch.bottom_sketch(seq, cfg["ordered_kmer_size"],
                                        cfg["ordered_sketch_size"])
    return OracleSketch(header_id, is_fwd, header, len(seq), mh, ordered, nk)


def sketch_all(reads: list[str], cfg, kmer_filter=None, headers=None,
               offset: int = 0, do_rc: bool = True) -> list[OracleSketch]:
    """Sketch fwd+rev of every read (SequenceSketchStreamer.enqueue).

    Reads shorter than min_olap_length are dropped; reads whose forward
    sketch has zero valid n-grams are skipped entirely; a failing reverse
    sketch leaves only the forward one (reference behavior, enqueue() +
    enqueueUntilFound()).
    """
    out = []
    fasta_index = 0  # FastaData numbering: every parsed read consumes an id
    for i, seq in enumerate(reads):
        fasta_index += 1
        hid = fasta_index + offset
        if len(seq) < cfg["min_olap_length"]:
            continue
        hdr = headers[i] if headers is not None else None
        try:
            out.append(sketch_read(seq, hid, True, hdr, cfg, kmer_filter))
        except _sketch.ZeroNGramsFound:
            continue
        if do_rc:
            try:
                out.append(sketch_read(reverse_complement(seq), hid, False,
                                       hdr, cfg, kmer_filter))
            except _sketch.ZeroNGramsFound:
                pass
    return out


@dataclass
class OracleIndex:
    """512 per-position hash tables (MinHashSearch.java:85-147)."""
    cfg: dict
    tables: list = field(default_factory=list)
    sketches: dict = field(default_factory=dict)

    def __post_init__(self):
        self.tables = [dict() for _ in range(self.cfg["num_hashes"])]

    def add(self, sk: OracleSketch):
        if sk.key in self.sketches:
            raise ValueError("Sequence ID already exists in the hash table.")
        self.sketches[sk.key] = sk
        for pos, val in enumerate(sk.min_hashes):
            self.tables[pos].setdefault(int(val), []).append(sk.key)

    def find_matches(self, q: OracleSketch, to_self: bool) -> list[str]:
        """MinHashSearch.findMatches(:149-251) -> list of output lines."""
        cfg = self.cfg
        votes: dict = {}
        for pos, val in enumerate(q.min_hashes):
            for key in self.tables[pos].get(int(val), ()):
                votes[key] = votes.get(key, 0) + 1

        lines = []
        for key, count in votes.items():
            m_hid, m_fwd = key
            if to_self and m_hid == q.header_id:
                continue
            if count < cfg["num_min_matches"]:
                continue
            cand = self.sketches[key]
            msl = cfg["min_store_length"]
            if cand.length < msl and q.length < msl:
                continue
            if to_self and m_hid > q.header_id and cand.length >= msl and q.length >= msl:
                continue
            if to_self and cand.length < msl and q.length >= msl:
                continue
            res = _scorer.get_overlap_info(q.ordered, q.num_kmers,
                                           cand.ordered, cand.num_kmers,
                                           cfg["ordered_kmer_size"],
                                           cfg["max_shift"])
            score, raw, a1, a2, b1, b2 = res
            if score >= cfg["threshold"]:
                lines.append(format_match(q, cand, score, raw, a1, a2, b1, b2))
        return lines


def format_match(q: OracleSketch, c: OracleSketch, score, raw,
                 a1, a2, b1, b2) -> str:
    """MatchResult coordinate flip + %.6f formatting (MatchResult.java)."""
    fa1 = a1 if q.is_fwd else q.length - a2 - 1
    fa2 = a2 if q.is_fwd else q.length - a1 - 1
    fb1 = b1 if c.is_fwd else c.length - b2 - 1
    fb2 = b2 if c.is_fwd else c.length - b1 - 1
    score = min(score, 1.0)
    return ("%s %s %.6f %.6f %d %d %d %d %d %d %d %d" % (
        q.display_header(), c.display_header(), 1.0 - score, raw,
        0 if q.is_fwd else 1, fa1, fa2, q.length,
        0 if c.is_fwd else 1, fb1, fb2, c.length))


def overlap_self(reads: list[str], cfg=None, kmer_filter=None, headers=None) -> list[str]:
    """Full self-overlap run; returns the set of output lines (sorted)."""
    c = dict(DEFAULTS)
    if cfg:
        c.update(cfg)
    sketches = sketch_all(reads, c, kmer_filter, headers)
    index = OracleIndex(c)
    for sk in sketches:
        index.add(sk)
    lines = []
    for sk in sketches:
        if sk.is_fwd:
            lines.extend(index.find_matches(sk, to_self=True))
    return sorted(lines)


def overlap_query(box_reads: list[str], query_reads: list[str], cfg=None,
                  kmer_filter=None, no_self: bool = False) -> list[str]:
    """Box-vs-query run (MhapMain usage 1 with -q)."""
    c = dict(DEFAULTS)
    if cfg:
        c.update(cfg)
    box = sketch_all(box_reads, c, kmer_filter)
    index = OracleIndex(c)
    for sk in box:
        index.add(sk)
    lines = []
    if not no_self:
        for sk in box:
            if sk.is_fwd:
                lines.extend(index.find_matches(sk, to_self=True))
    # MhapMain.computeMain: offset for -q files = numberProcessed/2 of the
    # box streamer, i.e. #enqueued sketches (fwd+rev) halved -- NOT the raw
    # read count (dropped reads shift subsequent file numbering).
    n_box = len(box) // 2
    queries = sketch_all(query_reads, c, kmer_filter, offset=n_box,
                         do_rc=False)
    for sk in queries:
        lines.extend(index.find_matches(sk, to_self=False))
    return sorted(lines)
