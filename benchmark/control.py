"""The control of the benchmark's check: the reference put in the port's
place with its identity computed in float32, one precision below the
configuration's float64.  The check has to find it not correct.

    python3 benchmark/control.py --workload NAME --seeds 1,2,3

For each seed: the cell's inputs, the reference's lines for the sampled
queries (float64, as the check computes them) and the control's (float32),
the control's lines judged as a run's would be.  Prints one JSON line a
seed with the numbers compared and whether the check passed.  Runs on the
card when there is one, else on the CPU; the benchmark's own runs never
run it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control(name, seed, device, root=ROOT, traffic_override=None,
            workers=None) -> dict:
    from benchmark import compare, traffic
    from benchmark.cell import Cell
    from benchmark.reference.overlaps import default_workers

    cell = Cell(name, root)
    spec = dict(cell.traffic, **(traffic_override or {}))
    workers = default_workers() if workers is None else workers
    workdir = tempfile.mkdtemp(prefix="mhap-control-")
    try:
        t0 = time.perf_counter()
        inputs = traffic.make_inputs(spec, cell.config, seed, workdir)
        ids = compare.sample_ids(inputs, spec["check"]["queries"])
        flags = cell.config["flags"]
        ref = compare.expected_lines(inputs, flags, ids, device,
                                     workers=workers)
        low = compare.expected_lines(inputs, flags, ids, device, f32=True,
                                     workers=workers)
        numbers = compare.judge(["\n".join(low) + "\n"], ref, ids)
        return {"workload": name, "seed": seed, "numbers": numbers,
                "passes": compare.passes(numbers),
                "seconds": time.perf_counter() - t0}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    device = "cuda" if torch.cuda.is_available() else "cpu"
    for s in args.seeds.split(","):
        print(json.dumps(control(args.workload, int(s), device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
