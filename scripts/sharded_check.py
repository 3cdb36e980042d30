#!/usr/bin/env python3
"""NCCL check of the port's sharded overlapper on a machine with 2 or
more GPUs, one rank a card.

    python3 scripts/sharded_check.py

For each world size D (2 and every card), spawns D ranks through
``mhap_tpu_torch.parallel.launch.run_ranks`` with NCCL, rank r on
``cuda:r``, and runs ``lognormal10k`` (bench.make_reads_placed(10_000,
seed=SEED + 1)) and ``filtered2k`` (chip_smoke.filtered2k, with its
filter file) twice each, a cold and a second run.  Each line set must be
sha256-equal to the native binary's on the same reads (``-f`` for
filtered2k) and the integer stats summed over the ranks equal at every
D.  Then runs the CLI under torchrun with one rank a card on the
primary reads against native.  Logs each rank's launches, peak device
memory, postings bytes and walls, and the card (nvidia-smi name and
power limit).  Exits non-zero on a mismatch, or with fewer than 2 cards.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        print(f"sharded_check: needs 2 or more GPUs, torch sees {n}",
              file=sys.stderr)
        return 2
    worlds = sorted({2, n})
    sys.path.insert(0, REPO)
    import bench
    import chip_smoke as cs
    from mhap_tpu_torch.ops import _build
    from mhap_tpu_torch.parallel import launch
    from mhap_tpu_torch.parallel.jobs import run_jobs
    from mhap_tpu_torch.parallel.sharded import _INT_STATS

    cs.log(f"card: {cs.nvidia_smi()} x {n}; torch {torch.__version__}, "
           f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.kernels()  # built once here, before the ranks load it
    cs.log(f"kernels built+loaded in {time.perf_counter() - t0:.1f} s")
    tmp = tempfile.TemporaryDirectory()
    reads10k, _, _ = bench.make_reads_placed(10_000, seed=bench.SEED + 1)
    reads_f, filter_path = cs.filtered2k(bench, tmp.name)
    fc = cs.read_filter(filter_path)
    want = {"lognormal10k": bench.bench_native(reads10k),
            "filtered2k": bench.bench_native(reads_f,
                                             extra=("-f", filter_path))}
    jobs = [("lognormal10k", dict(reads=reads10k)),
            ("filtered2k", dict(reads=reads_f, filter=fc))]
    jobs = [j for j in jobs for _ in range(2)]  # cold, then again
    failed = []
    stats_by_d = {}
    for D in worlds:
        t0 = time.perf_counter()
        res = launch.run_ranks(run_jobs, D, backend="nccl",
                               devices=[f"cuda:{r}" for r in range(D)],
                               args=([job for _name, job in jobs],))
        secs = time.perf_counter() - t0
        for j, (name, _job) in enumerate(jobs):
            ranks = [r[j] for r in res]
            _, n_nat, threads, nat_sha, nat_t = want[name]
            lines = ranks[0]["lines"]
            ok = (len(lines) == n_nat
                  and bench.lineset_sha256(lines) == nat_sha)
            stats = {k: sum(r["stats"][k] for r in ranks)
                     for k in _INT_STATS}
            stats_by_d.setdefault(name, {})[D] = stats
            cs.log(f"D={D} {name} ({'cold' if j % 2 == 0 else 'again'}): "
                   f"{len(lines)} lines (native {n_nat}, {nat_t} s on "
                   f"{threads} threads), sha256 equal: {ok}; stats {stats};"
                   f" by rank: wall {[round(r['seconds'], 3) for r in ranks]}"
                   f" s, launches {[r['launches'] for r in ranks]}, peak "
                   f"{[round(r['peak_bytes'] / 2**20, 1) for r in ranks]} "
                   f"MiB, postings "
                   f"{[round(r['index_bytes'] / 2**20, 2) for r in ranks]} "
                   f"MiB (launch {secs:.1f} s, processes included)")
            if not ok:
                failed.append(f"D={D} {name}")
    for name, by_d in stats_by_d.items():
        if len({tuple(s.values()) for s in by_d.values()}) != 1:
            failed.append(f"{name} stats differ across D: {by_d}")
    primary = bench.make_reads()
    _, n_nat, _, nat_sha, _ = bench.bench_native(primary)
    fa = cs.write_fasta(os.path.join(tmp.name, "primary.fa"), primary)
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc-per-node={n}", "-m", "mhap_tpu_torch.cli.main",
         "--backend", "sharded", "-s", fa], cwd=REPO, capture_output=True,
        text=True)
    lines = sorted(r.stdout.splitlines())
    ok = r.returncode == 0 and bench.lineset_sha256(lines) == nat_sha
    cs.log(f"torchrun --nproc-per-node {n} CLI on primary: {len(lines)} "
           f"lines (native {n_nat}), sha256 equal: {ok} "
           f"({time.perf_counter() - t0:.1f} s)")
    if not ok:
        failed.append(f"torchrun CLI: {r.stderr[-3000:]}")
    tmp.cleanup()
    if failed:
        print(f"sharded_check FAILED: {failed}", file=sys.stderr)
        return 1
    cs.log("sharded_check ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
