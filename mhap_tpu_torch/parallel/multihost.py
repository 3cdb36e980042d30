"""Multi-host layout of the port's ranks (the torch counterpart of
mhap_tpu/parallel/multihost.py).

The reference is single-process (SURVEY.md section 2.8); the JAX package
lays several hosts out as a (hosts, chips) mesh, the reads' data axis
over the hosts and the LSH band axis over a host's chips.  Here every
card is a rank of one ``torch.distributed`` group (``parallel/comm.py``),
launched by torchrun on each host:

  * ``initialize_from_env`` joins that group from torchrun's multi-node
    environment, or returns None when the process was not launched so;
  * ``host_card_grid`` gives the global ranks as a [hosts, cards] grid,
    the device grid that ``make_host_chip_mesh`` reshapes;
  * ``host_read_shard`` is the contiguous range of reads a host owns
    (``host_index`` says which host this process is on).

Like the JAX module it has no call site yet: ``parallel/sharded.py``
shards over the ranks of one group whatever hosts they sit on.
"""

from __future__ import annotations

import os

import numpy as np

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
        "LOCAL_WORLD_SIZE")


def initialize_from_env(backend: str):
    """The ``parallel.comm.Comm`` of this process when torchrun launched
    it (its multi-node environment: MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK, LOCAL_RANK, LOCAL_WORLD_SIZE), else None.  ``backend`` is the
    caller's: "nccl" on cards, "gloo" on the CPU.  The rank runs on
    ``cuda:LOCAL_RANK`` under NCCL and on the CPU under gloo."""
    if "MASTER_ADDR" not in os.environ:
        return None
    missing = [k for k in _ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"torchrun environment lacks {missing}")
    from . import comm

    local = int(os.environ["LOCAL_RANK"])
    device = f"cuda:{local}" if backend == "nccl" else "cpu"
    return comm.init(backend, int(os.environ["RANK"]),
                     int(os.environ["WORLD_SIZE"]), device,
                     init_method="env://")


def host_card_grid(world: int, local_world: int) -> np.ndarray:
    """Global ranks as a [hosts, cards] int64 grid: host h holds ranks
    h * local_world ... (h + 1) * local_world - 1, in torchrun's order,
    as make_host_chip_mesh reshapes jax.devices()."""
    if local_world < 1 or world % local_world:
        raise ValueError(f"world {world} is not a multiple of "
                         f"{local_world} ranks a host")
    return np.arange(world, dtype=np.int64).reshape(world // local_world,
                                                    local_world)


def host_index() -> tuple[int, int]:
    """(this host's index, number of hosts) from torchrun's environment,
    the counterpart of (jax.process_index(), jax.process_count()) with
    one JAX process a host; (0, 1) without that environment."""
    if "WORLD_SIZE" not in os.environ:
        return 0, 1
    local = int(os.environ["LOCAL_WORLD_SIZE"])
    return (int(os.environ["RANK"]) // local,
            int(os.environ["WORLD_SIZE"]) // local)


def host_read_shard(n_reads: int, process_id: int | None = None,
                    n_processes: int | None = None) -> slice:
    """Contiguous read-id range owned by this host (balanced remainder);
    the host and the count of hosts default to ``host_index()``."""
    pid, nproc = host_index()
    process_id = pid if process_id is None else process_id
    n_processes = nproc if n_processes is None else n_processes
    per = n_reads // n_processes
    extra = n_reads % n_processes
    start = process_id * per + min(process_id, extra)
    return slice(start, start + per + (1 if process_id < extra else 0))
