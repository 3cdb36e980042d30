"""One rank of a ``torch.distributed`` process group, with the few
collectives the sharded overlapper makes (counterpart of ``make_mesh``,
mhap_tpu/parallel/sharded.py:55).

JAX drives every device of a mesh from one controller; here each device
has a process of its own, rank r on its own device, and every rank makes
the same sequence of collective calls.  The caller names the backend when
it creates the group, and nothing picks one for it:

  * ``nccl``: one card a rank; the collectives run on device tensors;
  * ``gloo``: the collectives run on host tensors, so a device tensor is
    copied to the host and back around each one (the CPU tests, and
    several ranks sharing one card, which NCCL refuses).

Tensors of uneven sizes travel padded to the largest (all_gather,
gather) or with their splits exchanged first (all_to_all_v).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..device import resolve_device

I64 = torch.int64


class Comm:
    """``rank``, ``world`` and ``device`` of this process in the default
    process group, and its collectives.  Every result comes back on the
    device of the tensor given."""

    def __init__(self, device, owns_group: bool = False):
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.backend = dist.get_backend()
        self.device = torch.device(device)
        # where the collectives' tensors live
        self.wire = (self.device if self.backend == "nccl"
                     else torch.device("cpu"))
        self._owns_group = owns_group

    def close(self) -> None:
        """Destroys the process group if this Comm created it."""
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._owns_group = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM):
        x = t.to(self.wire, copy=True)
        dist.all_reduce(x, op)
        return x.to(t.device)

    def max_int(self, v: int) -> int:
        return int(self.all_reduce(torch.tensor([v], dtype=I64),
                                   dist.ReduceOp.MAX))

    def _sizes(self, n: int) -> list:
        out = [torch.zeros(1, dtype=I64, device=self.wire)
               for _ in range(self.world)]
        dist.all_gather(out, torch.tensor([n], dtype=I64, device=self.wire))
        return [int(x) for x in out]

    def _padded(self, t: torch.Tensor, rows: int) -> torch.Tensor:
        x = torch.zeros((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                        device=self.wire)
        x[:t.shape[0]] = t
        return x

    def all_gather(self, t: torch.Tensor) -> list:
        """Every rank's ``t`` (first dimensions may differ), by rank."""
        sizes = self._sizes(t.shape[0])
        rows = max(max(sizes), 1)
        out = [torch.empty((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                           device=self.wire) for _ in sizes]
        dist.all_gather(out, self._padded(t, rows))
        return [x[:n].to(t.device) for x, n in zip(out, sizes)]

    def gather(self, t: torch.Tensor, dst: int = 0):
        """Every rank's ``t`` at rank ``dst``, by rank; None elsewhere."""
        sizes = self._sizes(t.shape[0])
        rows = max(max(sizes), 1)
        out = None
        if self.rank == dst:
            out = [torch.empty((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                               device=self.wire) for _ in sizes]
        dist.gather(self._padded(t, rows), out, dst=dst)
        if out is None:
            return None
        return [x[:n].to(t.device) for x, n in zip(out, sizes)]

    def all_to_all_v(self, t: torch.Tensor, splits):
        """Sends rows ``[sum(splits[:d]), sum(splits[:d + 1]))`` of ``t``
        to rank d.  Returns (the rows received, by source rank, in one
        tensor; the count from each rank)."""
        splits = [int(x) for x in splits]
        sent = torch.tensor(splits, dtype=I64, device=self.wire)
        got = torch.empty_like(sent)
        dist.all_to_all_single(got, sent)
        recv_splits = got.tolist()
        out = torch.empty((sum(recv_splits),) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=self.wire)
        dist.all_to_all_single(out, t.to(self.wire).contiguous(),
                               recv_splits, splits)
        return out.to(t.device), recv_splits

    def all_gather_bytes(self, blob: bytes) -> list:
        return [bytes(x.numpy()) for x in self.all_gather(_u8(blob))]

    def gather_bytes(self, blob: bytes, dst: int = 0):
        out = self.gather(_u8(blob), dst)
        return None if out is None else [bytes(x.numpy()) for x in out]


def _u8(blob: bytes) -> torch.Tensor:
    return torch.frombuffer(bytearray(blob), dtype=torch.uint8) if blob \
        else torch.zeros(0, dtype=torch.uint8)


def init(backend: str, rank: int, world: int, device, *, store=None,
         init_method=None) -> Comm:
    """Joins (creates) the default process group as ``rank`` of
    ``world`` on ``device``, through ``store`` or ``init_method``; the
    returned Comm destroys the group when closed.  A CUDA device becomes
    the current device first, before any tensor or launch."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, store=store,
                            rank=rank, world_size=world)
    return Comm(device, owns_group=True)


def single(backend: str, device) -> Comm:
    """A group of one rank, joined through an in-process store."""
    return init(backend, 0, 1, device, store=dist.HashStore())
