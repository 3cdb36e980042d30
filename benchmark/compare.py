"""The comparison that decides ``correct``.

Every job of a run reads the same input, so every job's M4 text has to be
the same (``jobs_differing``).  The first window job's lines are then held
against the plain reference (``reference/``) for a sample of queries drawn
from the seed, with the longest read of each block among them: for each
sampled read number, every line the port printed with it as the A read
against every line the reference computes for it from the reads and the
filter file.  Any line missing or extra fails the run, as does a sample
in which the reference finds no line at all.
"""

from __future__ import annotations

import hashlib

import numpy as np

from .reference.filter import FilterFile
from .reference.overlaps import Rows, Search

# marbl/MHAP v2.1.3 MhapMain defaults of the flags the reference reads
DEFAULTS = {"-k": 16, "--num-hashes": 512, "--num-min-matches": 3,
            "--threshold": 0.78, "--ordered-kmer-size": 12,
            "--ordered-sketch-size": 1536, "--max-shift": 0.2,
            "--min-store-length": 0, "--min-olap-length": 116,
            "--repeat-weight": 0.9, "--repeat-idf-scale": 3.0,
            "--filter-threshold": 1e-5, "--supress-noise": 0,
            "--no-tf": False, "--no-rc": False}

# each number compared: (its limit, whether the limit is a maximum)
LIMITS = {"jobs_differing": (0, True), "lines_missing": (0, True),
          "lines_extra": (0, True), "lines_expected": (1, False)}


def settings(flags: dict) -> dict:
    unknown = set(flags) - set(DEFAULTS) - {"-f"}
    if unknown:
        raise ValueError(f"the reference does not run {sorted(unknown)}")
    f = {**DEFAULTS, **flags}
    return dict(kmer_size=f["-k"], num_hashes=f["--num-hashes"],
                num_min_matches=f["--num-min-matches"],
                threshold=f["--threshold"],
                ordered_kmer_size=f["--ordered-kmer-size"],
                ordered_sketch_size=f["--ordered-sketch-size"],
                max_shift=f["--max-shift"],
                min_store_length=f["--min-store-length"],
                min_olap_length=f["--min-olap-length"],
                repeat_weight=f["--repeat-weight"],
                idf_range=f["--repeat-idf-scale"],
                filter_threshold=f["--filter-threshold"],
                supress_noise=f["--supress-noise"], no_tf=f["--no-tf"],
                do_rc=not f["--no-rc"])


def sample_ids(inputs, n: int) -> list:
    """Read numbers (1-based within a block) to check: the longest read
    of each block and random others, n in all (or every read)."""
    size = min(hi - lo for lo, hi in inputs.blocks)
    want = set()
    for lo, hi in inputs.blocks:
        lens = [len(r) for r in inputs.reads[lo:lo + size]]
        want.add(int(np.argmax(lens)) + 1)
    rest = [i for i in range(1, size + 1) if i not in want]
    k = max(0, min(n - len(want), len(rest)))
    want.update(int(i) for i in inputs.sample_rng.choice(rest, k,
                                                         replace=False))
    return sorted(want)


def expected_lines(inputs, flags: dict, ids, device, f32=False,
                   workers=0) -> list:
    """The reference's lines whose A read is one of ``ids``: each block's
    read searched against block 0, itself by the self rules when the job
    is all against all of block 0 and the rest as query files."""
    cfg = settings(flags)
    weigh = None
    if inputs.filter_path is not None:
        weigh = FilterFile(inputs.filter_path, cfg["filter_threshold"],
                           cfg["repeat_weight"], cfg["supress_noise"],
                           cfg["no_tf"], cfg["idf_range"],
                           cfg["do_rc"]).weights
    lo, hi = inputs.blocks[0]
    store = Rows.of_reads(inputs.reads[lo:hi], 0, cfg["do_rc"],
                          cfg["min_olap_length"])
    search = Search(store, cfg, device, weigh)
    shown = {str(i) for i in ids}
    rows = [j for j in range(len(store.hid))
            if store.fwd[j] and store.shown[j] in shown]
    out = search.lines(store, rows, True, f32, workers)
    offset = len(store.hid) // 2
    for lo, hi in inputs.blocks[1:]:
        q = Rows.of_reads(inputs.reads[lo:hi], offset, False,
                          cfg["min_olap_length"])
        rows = [j for j in range(len(q.hid)) if q.shown[j] in shown]
        out += search.lines(q, rows, False, f32, workers)
        offset += len(q.hid)
    return out


def text_sha256(parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(p.encode())
    return h.hexdigest()


def judge(outputs, reference, ids) -> dict:
    """The numbers compared: outputs are the jobs' stdout parts, the
    first of them checked line by line for ``ids``."""
    first = text_sha256(outputs[0]) if outputs else None
    differing = sum(text_sha256(o) != first for o in outputs[1:])
    shown = {str(i) for i in ids}
    port = [ln for ln in "".join(outputs[0]).split("\n")
            if ln and ln.split(" ", 1)[0] in shown] if outputs else []
    ref = set(reference)
    got = set(port)
    return {"jobs_differing": differing,
            "lines_missing": len(ref - got),
            "lines_extra": len(got - ref) + len(port) - len(got),
            "lines_expected": len(reference)}


def passes(numbers: dict) -> bool:
    return all((numbers[k] <= lim) if is_max else (numbers[k] >= lim)
               for k, (lim, is_max) in LIMITS.items())
