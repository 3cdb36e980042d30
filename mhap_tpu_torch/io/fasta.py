"""Streaming FASTA/FASTQ reading (the port's copy of mhap_tpu/io/fasta.py).

Parity target: impl/FastaData.java -- uppercase sequences, optional
full-header ids (first whitespace/comma-delimited token,
FastaData.java:154) and transparent gz/bz2 decompression
(utils/Utils.getFile, :228-266).  FASTQ input is an extension the
reference lacks.
"""

from __future__ import annotations

import bz2
import gzip
import io
import os
import re

FASTQ_SUFFIXES = ("fastq", "fq")


def open_text(path: str):
    """Transparent plain/gz/bz2 text reader (Utils.getFile)."""
    if path.endswith(".gz"):
        return io.TextIOWrapper(gzip.open(path, "rb"), encoding="ascii")
    if path.endswith(".bz2"):
        return io.TextIOWrapper(bz2.open(path, "rb"), encoding="ascii")
    return open(path, "r", encoding="ascii", buffering=1 << 23)


def _strip_compress_suffix(name: str) -> str:
    for s in (".gz", ".bz2"):
        if name.endswith(s):
            return name[:-len(s)]
    return name


def list_sequence_files(path: str) -> list[str]:
    """File or directory -> sorted file list: ALL non-hidden files of a
    directory, alphabetically (MhapMain.java:386-400, :498-510)."""
    if os.path.isdir(path):
        return [os.path.join(path, f) for f in sorted(os.listdir(path))
                if not f.startswith(".")]
    return [path]


def read_sequences(path: str, store_full_id: bool = False):
    """Yield (header_or_None, sequence) in file order; the header is the
    first [\\s,]-delimited token after '>' (or '@') when store_full_id."""
    base = _strip_compress_suffix(path)
    is_fastq = base.rsplit(".", 1)[-1].lower() in FASTQ_SUFFIXES
    with open_text(path) as f:
        if is_fastq:
            yield from _read_fastq(f, store_full_id)
        else:
            yield from _read_fasta(f, store_full_id)


def _split_header(line: str) -> str:
    return re.split(r"[\s,]+", line, maxsplit=1)[0]


def _read_fasta(f, store_full_id: bool):
    header = None
    chunks: list[str] = []
    started = False
    for line in f:
        line = line.rstrip("\n").rstrip("\r")
        if line.startswith(">"):
            if started and chunks:
                yield header, "".join(chunks).upper()
            header = _split_header(line[1:]) if store_full_id else None
            chunks = []
            started = True
        else:
            if not started:
                raise ValueError(
                    "Next sequence does not start with >. Invalid format.")
            chunks.append(line)
    if started and chunks:
        yield header, "".join(chunks).upper()


def _read_fastq(f, store_full_id: bool):
    while True:
        h = f.readline()
        if not h:
            return
        h = h.rstrip("\n")
        if not h:
            continue
        if not h.startswith("@"):
            raise ValueError("FASTQ record does not start with @.")
        seq = f.readline().rstrip("\n")
        plus = f.readline()
        f.readline()  # quality line
        if not plus.startswith("+"):
            raise ValueError("FASTQ separator line missing.")
        header = _split_header(h[1:]) if store_full_id else None
        yield header, seq.upper()
