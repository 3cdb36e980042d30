"""Overlap output formats (the port's copy of mhap_tpu/io/formats.py).

M4 is the reference's format (impl/MatchResult.java:98-113):
  [Aid] [Bid] [1-score] [rawScore] [AisRC] [Astart] [Aend] [Alen]
  [BisRC] [Bstart] [Bend] [Blen]
``--paf`` converts each line to PAF.  A batch of lines travels as
``M4Lines``, one byte buffer, from formatting to the output.
"""

from __future__ import annotations

import numpy as np

from ..utils import trace
from ..utils.native import m4_sort


class M4Lines:
    """A batch of M4 lines as one UTF-8 buffer: ``data``, a uint8 array,
    holds ``count`` lines, each ended by a newline.  ``+`` concatenates
    batches (or a ``list[str]``); ``sorted()`` orders the lines as
    Python's ``sorted`` orders their ``str``; ``tolist()`` and iteration
    give the ``str`` lines."""

    __slots__ = ("data", "count")

    def __init__(self, data=None, count: int = 0):
        self.data = np.zeros(0, np.uint8) if data is None else data
        self.count = count

    @classmethod
    def of(cls, lines) -> "M4Lines":
        """``lines`` as a batch: an ``M4Lines`` as it is, or str lines."""
        if isinstance(lines, M4Lines):
            return lines
        lines = list(lines)
        text = "\n".join(lines) + "\n" if lines else ""
        return cls(np.frombuffer(text.encode(), np.uint8), len(lines))

    def __add__(self, other) -> "M4Lines":
        other = M4Lines.of(other)
        return M4Lines(np.concatenate([self.data, other.data]),
                       self.count + other.count)

    def __len__(self) -> int:
        return self.count

    def __iter__(self):
        return iter(self.tolist())

    def sorted(self) -> "M4Lines":
        return M4Lines(m4_sort(self.data), self.count)

    def text(self) -> str:
        return str(self.data, "utf-8")

    def tolist(self) -> list[str]:
        return self.text().split("\n")[:-1]


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
    """Writes ``lines`` (an ``M4Lines`` or a ``list[str]``) to ``out`` in
    one write, as PAF with ``paf``; returns the count of lines."""
    lines = M4Lines.of(lines)
    with trace.span("write"):
        if lines.count:
            out.write("".join(m4_to_paf(line) + "\n" for line in lines)
                      if paf else lines.text())
    return lines.count
