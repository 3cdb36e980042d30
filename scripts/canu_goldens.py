#!/usr/bin/env python3
"""The JAX package's goldens for chip_smoke.py phase 10 (the Canu path),
made on the CPU:

    JAX_PLATFORMS=cpu python scripts/canu_goldens.py [--n 2048] [--out DIR]

It builds phase 10's input with ``chip_smoke.canu_input`` (two FASTA
blocks of n / 2 reads and the filter file), then runs
  1. the JAX CLI ``-p blocks/ -q dats/`` and ``-s dats/block0.dat -q
     querydir/`` (querydir holding block1.dat), both with ``-f kmers.txt
     --supress-noise 2 --repeat-weight 0.9 --repeat-idf-scale 10``, as
     subprocesses: the sha256 of each .dat file, and the line count and
     line-set sha256 of the second run;
  2. ``TpuOverlapper(kmer_filter=VectorFrequencyFilter(FrequencyCounts(
     f, 1e-5, 0.9, 1, False, 10.0, True))).overlap_self(reads)``, mode 1
     with the exact set: its line count and line-set sha256;
and prints one JSON line with those and each step's seconds.  At n =
2,048 the three steps take some 3, 13 and 21 minutes on 8 shared cores.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--supress-noise", "2", "--repeat-weight", "0.9",
         "--repeat-idf-scale", "10"]


def sha256_file(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import bench
    import chip_smoke

    out = args.out or tempfile.mkdtemp()
    reads, blocks, kpath = chip_smoke.canu_input(bench, out, args.n)
    dats, qdir = os.path.join(out, "dats"), os.path.join(out, "querydir")
    os.makedirs(dats, exist_ok=True)
    os.makedirs(qdir, exist_ok=True)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    cli = [sys.executable, "-m", "mhap_tpu.cli.main"]
    res = {"n_reads": args.n}
    t0 = time.time()
    subprocess.run(cli + ["-p", blocks, "-q", dats, "-f", kpath] + FLAGS,
                   cwd=REPO, env=env, check=True, capture_output=True)
    res["p_seconds"] = time.time() - t0
    for b in ("block0.dat", "block1.dat"):
        res[f"{b}_sha256"] = sha256_file(os.path.join(dats, b))
    shutil.copy(os.path.join(dats, "block1.dat"), qdir)
    t0 = time.time()
    r = subprocess.run(cli + ["-s", os.path.join(dats, "block0.dat"), "-q",
                              qdir, "-f", kpath] + FLAGS, cwd=REPO, env=env,
                       check=True, capture_output=True, text=True)
    res["sq_seconds"] = time.time() - t0
    lines = r.stdout.splitlines()
    res["sq_lines"] = len(lines)
    res["sq_sha256"] = bench.lineset_sha256(lines)

    from mhap_tpu.io.fasta import open_text
    from mhap_tpu.oracle.filter import FrequencyCounts
    from mhap_tpu.pipeline.freqfilter import VectorFrequencyFilter
    from mhap_tpu.pipeline.overlapper import TpuOverlapper

    with open_text(kpath) as f:
        fc = FrequencyCounts(f, 1e-5, 0.9, 1, False, 10.0, True)
    t0 = time.time()
    lines = TpuOverlapper(kmer_filter=VectorFrequencyFilter(fc)
                          ).overlap_self(reads)
    res["mode1_seconds"] = time.time() - t0
    res["mode1_lines"] = len(lines)
    res["mode1_sha256"] = bench.lineset_sha256(lines)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
