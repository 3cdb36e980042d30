"""Overlap output formats (the port's copy of mhap_tpu/io/formats.py).

M4 is the reference's format (impl/MatchResult.java:98-113):
  [Aid] [Bid] [1-score] [rawScore] [AisRC] [Astart] [Aend] [Alen]
  [BisRC] [Bstart] [Bend] [Blen]
``--paf`` converts each line to PAF.
"""

from __future__ import annotations

from ..utils import trace


def m4_to_paf(line: str) -> str:
    """One M4 line as PAF: qname qlen qstart qend strand tname tlen tstart
    tend residueMatches alignmentBlockLen mapq, plus the M4 error column as
    a ``de:f:`` tag; rawScore (shared min-mers) fills residueMatches."""
    p = line.split()
    (aid, bid, err, raw, a_rc, a1, a2, alen, b_rc, b1, b2, blen) = p[:12]
    a1, a2, alen = int(a1), int(a2), int(alen)
    b1, b2, blen = int(b1), int(b2), int(blen)
    # exactly one side may be RC; PAF gives the strand relative to A
    strand = "-" if (int(a_rc) + int(b_rc)) % 2 else "+"
    if int(a_rc):  # flip A to forward coordinates
        a1, a2 = alen - a2 - 1, alen - a1 - 1
    if int(b_rc):
        b1, b2 = blen - b2 - 1, blen - b1 - 1
    block = max(a2 - a1, b2 - b1)
    nmatch = int(float(raw))
    return "\t".join(str(x) for x in (
        aid, alen, a1, a2, strand, bid, blen, b1, b2, nmatch, block, 255,
        f"de:f:{float(err):.6f}"))


def write_lines(lines, out, paf: bool = False) -> int:
    n = 0
    with trace.span("write"):
        for line in lines:
            out.write((m4_to_paf(line) if paf else line) + "\n")
            n += 1
    return n
