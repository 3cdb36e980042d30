#!/usr/bin/env python3
"""The native reference's goldens for the scale inputs' card tests
(tests/test_torch_card_paths.py: scale40k, scale100k, repeat40k), made
on the CPU:

    python scripts/scale_goldens.py [--configs scale40k,scale100k,repeat40k]

Each input is built by ``torch_card_inputs.scale_input`` as bench.py's
bench_config_scale40k, bench_config_scale100k and bench_config_repeat40k
build it, then run once through ``bench.bench_native`` (the native C++
reference, native/mhap_cpu.cc, on every host core; ``-f kmers.txt`` for
repeat40k).  Prints one JSON line with each input's line count, line-set
sha256 (``bench.lineset_sha256``), native seconds and the seconds taken
to build the input.  repeat40k prints ~29.5M lines: its line set alone
holds some 13 GB of host memory while it is hashed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import bench
    import torch_card_inputs

    ap = argparse.ArgumentParser()
    ap.add_argument("--configs",
                    default=",".join(torch_card_inputs.SCALE_INPUTS))
    args = ap.parse_args()
    res = {}
    for name in args.configs.split(","):
        with tempfile.TemporaryDirectory() as td:
            t0 = time.time()
            reads, fpath = torch_card_inputs.scale_input(bench, name, td)
            made = time.time() - t0
            extra = ["-f", fpath] if fpath else []
            _, n_lines, threads, sha, times = bench.bench_native(
                reads, extra=extra)
        res[name] = {"lines": n_lines, "sha256": sha,
                     "native_seconds": times[0], "threads": threads,
                     "input_seconds": round(made, 1)}
        print(f"[scale_goldens] {name}: {res[name]}", file=sys.stderr,
              flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
