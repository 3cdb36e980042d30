"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout, on a machine with as many CUDA devices
as the cell asks for.  Prints the result as one JSON object, the last line
of standard output, and the numbers the check compared, each beside its
limit, as the last lines of standard error.  Exits with another code than
0, and prints no result, without the devices, when the run fails, or when
JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# host threads and cores of a run, the same on every machine: the jobs are
# one Python thread with the device's and the libraries' threads beside it
THREADS = 4
CORES = 4


def node_cpus() -> set:
    """The CPUs of the machine's first NUMA node, or None if unknown."""
    try:
        with open("/sys/devices/system/node/node0/cpulist") as f:
            text = f.read().strip()
    except OSError:
        return None
    cpus = set()
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        cpus.update(range(int(lo), int(hi or lo) + 1))
    return cpus


def steady_host():
    """Fixes the run's thread counts and pins it to CORES cores of one
    NUMA node, the last ones, away from the first core's interrupts.
    Returns the affinity it replaced."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                "OPENBLAS_NUM_THREADS"):
        os.environ[var] = str(THREADS)
    before = os.sched_getaffinity(0)
    node = node_cpus()
    pick = sorted(before & node) if node and before & node else sorted(
        before)
    os.sched_setaffinity(0, pick[-CORES:])
    return before


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    before = steady_host()
    import torch

    torch.set_num_threads(THREADS)

    from benchmark.cell import Cell, banned_modules, run_cell

    chips = Cell(args.workload, ROOT).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); torch "
              f"sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    # the check's reference runs on every core
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", ROOT, T_START,
                      after_jobs=lambda: os.sched_setaffinity(0, before))
    found = banned_modules()
    if found:
        print(f"benchmark: JAX or the JAX package loaded: {found}",
              file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        rel = "<=" if v["at_most"] else ">="
        print(f"check {k} = {v['value']} (limit {rel} {v['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
