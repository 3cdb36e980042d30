#!/usr/bin/env python3
"""The JAX package's goldens for EstimateROC's card tests
(tests/test_torch_card_paths.py), made on the CPU:

    JAX_PLATFORMS=cpu python scripts/roc_goldens.py [--out DIR]

For two inputs, each with its truth placements:
  * lognormal10k, as bench.bench_config_lognormal builds it
    (``bench.make_reads_placed(10_000, seed=SEED + 1)``);
  * filtered2k (``torch_card_inputs.filtered2k_placed``: 2,048 reads
    from a genome with a 2 kb repeat implanted 40 times) with its filter
    file;
it takes the native binary's line set on those reads (with ``-f`` for
filtered2k; sha256-equal to the JAX package's and to the port's: 158,246
and 286,410 lines), sorted as overlap_self returns them, writes the
truth, overlap and FASTA files with ``torch_card_inputs.roc_files`` and
runs the JAX ``EstimateROC(min_ovl_len=500, num_trials=2000,
do_dp=True)`` through ``estimate_sensitivity``,
``estimate_specificity`` and ``estimate_ppv(batch_dp=True)``, as
bench_config_lognormal does.  The batched Smith-Waterman call of that
run, if any, is recorded by a wrapper around
``mhap_tpu.ops.swalign.sw_align_batch`` set in this process only (the
package's files are not touched): its pairs' shapes and the sha256 of
its eight output columns (``torch_card_inputs.sw_sha256``).  Then the JAX
tool's entry point, ``python -m mhap_tpu.tools.estimate_roc truth.m4
ovl.mhap reads.fa 500 2000 true`` (per-pair native DP), as a subprocess:
its three stdout lines.  Prints one JSON line per input with all of it
and each step's seconds.  On 8 shared cores: lognormal10k ~30 s;
filtered2k's batched call pads its 1,713 disputed pairs to [1,713,
2,889] and [1,713, 2,849] and takes 8 minutes, its CLI 46 s.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def golden(name, reads, placements, genome_len, extra, out):
    import numpy as np

    import bench
    import torch_card_inputs as cs
    from mhap_tpu.ops import swalign
    from mhap_tpu.tools.estimate_roc import EstimateROC

    res = {"input": name}
    t0 = time.time()
    _, n_lines, _, sha, _, lines = bench.bench_native(
        reads, extra=extra, return_lines=True)
    res.update(native_lines=n_lines, native_sha256=sha,
               native_seconds=time.time() - t0)
    # in the overlappers' order (overlap_self returns the lines sorted):
    # EstimateROC numbers the overlaps in file order for its PPV draws
    truth, ovls, fa = cs.roc_files(bench, out, reads, placements,
                                   genome_len, sorted(lines))
    calls = []
    plain = swalign.sw_align_batch

    def recorded(q, ql, r, rl, **kw):
        o = plain(q, ql, r, rl, **kw)
        calls.append((np.asarray(ql), np.asarray(rl), q.shape, r.shape,
                      {k: np.asarray(v) for k, v in o.items()}))
        return o

    swalign.sw_align_batch = recorded
    try:
        t0 = time.time()
        roc = EstimateROC(min_ovl_len=500, num_trials=2000, do_dp=True)
        roc.process_reference(truth)
        roc.load_fasta(fa)
        roc.process_overlaps(ovls)
        roc.estimate_sensitivity()
        roc.estimate_specificity()
        res["load_sens_spec_seconds"] = time.time() - t0
        t0 = time.time()
        roc.estimate_ppv(batch_dp=True)
        res["ppv_seconds"] = time.time() - t0
    finally:
        swalign.sw_align_batch = plain
    res.update(tp=roc.tp, fn=roc.fn, tn=roc.tn, fp=roc.fp,
               sensitivity=roc.sensitivity(),
               specificity=roc.specificity(), ppv=roc.ppv,
               disputed=0, sw_calls=len(calls))
    if calls:
        ql, rl, qshape, rshape, sw = calls[0]
        cells = ql.astype(np.int64) * rl
        res.update(disputed=len(ql), q_shape=list(qshape),
                   r_shape=list(rshape), max_cells=int(cells.max()),
                   cells=int(cells.sum()),
                   sw_sha256=cs.sw_sha256(sw))
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "mhap_tpu.tools.estimate_roc",
                        truth, ovls, fa, "500", "2000", "true"], cwd=REPO,
                       env=dict(os.environ, JAX_PLATFORMS="cpu",
                                PYTHONPATH=REPO),
                       check=True, capture_output=True, text=True)
    res["cli_seconds"] = time.time() - t0
    res["cli_stdout"] = r.stdout.splitlines()
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import bench
    import torch_card_inputs as cs

    out = args.out or tempfile.mkdtemp()
    reads, placements, glen = bench.make_reads_placed(
        10_000, seed=bench.SEED + 1)
    d = os.path.join(out, "lognormal10k")
    os.makedirs(d, exist_ok=True)
    print(json.dumps(golden("lognormal10k", reads, placements, glen, (),
                            d)), flush=True)
    reads, placements, glen, _ = cs.filtered2k_placed(bench)
    d = os.path.join(out, "filtered2k")
    os.makedirs(d, exist_ok=True)
    _, fpath = cs.filtered2k(bench, d)
    print(json.dumps(golden("filtered2k", reads, placements, glen,
                            ("-f", fpath), d)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
