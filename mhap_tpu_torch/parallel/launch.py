"""Runs a function on ``world`` ranks, each a spawned process.

    results = run_ranks(fn, world, backend="nccl",
                        devices=[f"cuda:{r}" for r in range(world)],
                        args=(...))

Each rank joins the process group through a ``FileStore`` in a temporary
directory (no port), makes its device current before any tensor or
launch (and runs one intra-op thread on the CPU), calls
``fn(comm, *args)`` with its ``parallel.comm.Comm`` and writes what
``fn`` returns, which must pickle, as ``args`` must, to a file the
parent reads back.  ``fn`` is a module-level function of this package
(``parallel/jobs.py``): a spawned process imports the module of its
target anew, and a test module would bring JAX with it.  A rank that
raises stops the others (``torch.multiprocessing``'s join), and its
traceback comes back in the ``ProcessRaisedException``.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from . import comm as _comm


def _rank_main(rank, fn, world, backend, devices, tmp):
    with open(os.path.join(tmp, "args.pkl"), "rb") as f:
        args = pickle.load(f)  # written by run_ranks
    dev = torch.device(devices[rank])
    if dev.type == "cpu":
        torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    with _comm.init(backend, rank, world, dev, store=store) as c:
        result = fn(c, *args)
    with open(os.path.join(tmp, f"result{rank}.pkl"), "wb") as f:
        pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)


def run_ranks(fn, world: int, *, backend: str, devices, args=()) -> list:
    """``fn(comm, *args)`` on ranks 0..world-1, rank r on ``devices[r]``.
    Returns the results by rank."""
    devices = [str(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    with tempfile.TemporaryDirectory() as tmp:
        # the arguments go through a file: a process's start blocks until
        # the child has read what start() pipes to it, which it does after
        # importing fn's module, so large arguments there would start the
        # ranks one after another
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump(args, f, protocol=pickle.HIGHEST_PROTOCOL)
        mp.start_processes(_rank_main, args=(fn, world, backend, devices,
                                             tmp),
                           nprocs=world, join=True, start_method="spawn")
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"result{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
    return out
