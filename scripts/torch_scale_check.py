#!/usr/bin/env python3
"""The port at bench.py's scale on one NVIDIA GPU, against the native
goldens:

    python3 scripts/torch_scale_check.py [--inputs NAME,...] [--out FILE]

Each input of ``--inputs`` (default all three; chip_smoke.scale_input:
scale40k, scale100k, or repeat40k with its filter file read as bench_config_repeat40k reads it) runs in a
process of its own, so that its peak host RSS is its own:
``TorchOverlapper().overlap_self`` once cold (launch counters reset
before and read after), two settling runs (the second split into stages
by profile_stages.stage_times), then three timed runs (chip_smoke.
scale_run).  Every run's line count and line-set sha256 must equal the
golden (chip_smoke.SCALE_GOLDENS); a difference exits non-zero.  Prints
the card (nvidia-smi name and power limit), then a summary line and one
JSON line an input: cold wall, settling walls, steady median with the
three runs, the stage split (seconds), peak device memory (the run's
and the vote's), peak host RSS, kernel launches, store rows, candidate
pairs, hits and the largest hit chunk.  ``--out`` also writes the JSON
lines to FILE.  Needs a CUDA GPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_one(name: str) -> dict:
    """One input in this process (see the module's docstring)."""
    sys.path.insert(0, REPO)
    import bench
    import chip_smoke
    from mhap_tpu_torch.ops.minhash_kernels import (min_reduce_w1,
                                                    weighted_min_reduce)
    from mhap_tpu_torch.ops.scorer_kernels import score_pairs
    from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    kern = {"min_reduce_w1": min_reduce_w1,
            "weighted_min_reduce": weighted_min_reduce,
            "score_pairs": score_pairs}
    with tempfile.TemporaryDirectory() as tmp:
        reads, fpath = chip_smoke.scale_input(bench, name, tmp)
        kmer_filter = None
        if fpath is not None:
            kmer_filter = VectorFrequencyFilter(
                chip_smoke.read_filter(fpath), "cuda")
    # a filter file weights every row, so every row takes kernel 2
    need = ("min_reduce_w1" if kmer_filter is None
            else "weighted_min_reduce", "score_pairs")
    res = chip_smoke.scale_run(
        bench, TorchOverlapper(kmer_filter=kmer_filter), reads, name, kern,
        need, 1, 3)
    print(f"[scale] {chip_smoke.scale_summary(res)}", file=sys.stderr,
          flush=True)
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inputs", default="scale40k,scale100k,repeat40k")
    ap.add_argument("--out", default=None, help="also write the JSON "
                    "lines here")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_scale_check: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    if args.one:
        print(json.dumps(run_one(args.one)), flush=True)
        return 0
    sys.path.insert(0, REPO)
    import chip_smoke

    print(chip_smoke.nvidia_smi(), flush=True)
    rc = 0
    for name in args.inputs.split(","):
        r = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--one", name], cwd=REPO, stdout=subprocess.PIPE,
                           text=True)
        if r.returncode != 0:
            print(f"torch_scale_check: {name} exited {r.returncode}",
                  file=sys.stderr, flush=True)
            rc = 1
            continue
        line = r.stdout.strip().splitlines()[-1]
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
