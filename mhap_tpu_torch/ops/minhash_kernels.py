"""Wrappers of the CUDA min-reduce kernels (``csrc/minhash.cu``).

Kernel 1, ``min_reduce_w1``, replaces ``min_reduce_w1_pallas``
(mhap_tpu/ops/minhash_pallas.py:156); kernel 2, ``weighted_min_reduce``,
replaces ``weighted_min_reduce_pallas`` (:193).  For CPU tensors each
wrapper runs its plain version from ``ops/minhash.py``; for CUDA tensors
it launches the kernel or raises.  ``launches`` counts the wrapper's
launches: one per call of kernel 1, one per three-pass call of kernel 2.

Kernel 2 runs as three passes (light, heavy, fold; the source note of
``csrc/minhash.cu``) over a plan made here in plain PyTorch
(``light_segments``, ``heavy_kmers``, ``heavy_unit_slots``), which the
CPU tests reach too.

Kernel 1 keeps H * 16 bytes of running bests a block, and kernel 2's
light pass 8 * H * 16: in shared memory while that fits the card's opt-in
limit a block (on the H100, H up to 14,272 and 1,816), else in a
device-memory workspace allocated here, one slice for each of a grid of
resident blocks (``_build.workspace``; ``plan`` says which path H
takes).  Any H runs.
"""

from __future__ import annotations

import torch

from ..utils import trace
from . import _build
from .minhash import (JUMP_BITS, min_reduce_w1_ref, weighted_min_reduce_ref,
                      xorshift_jump_table)

TILE = 256 * 16      # k-mers of the light pass's register tile
HEAVY_MIN = 16       # k-mers of weight >= HEAVY_MIN go to the heavy pass
JUMP_STEPS = 1024    # stream steps a heavy unit takes, about a jump's cost
BLOCKS_PER_SM = 1    # fewer light-pass blocks than this a SM: cut tiles
HEAVY_CELLS = 1 << 24  # heavy k-mers x slots of window minima per launch


def heavy_unit_slots(w: torch.Tensor, num_hashes: int,
                     jump_steps: int = JUMP_STEPS) -> torch.Tensor:
    """Slots r of each unit of heavy k-mers of weight w: the heavy pass's
    thread q of a k-mer takes slots [q * r, min(H, (q + 1) * r)), so a
    unit steps about jump_steps times after its jump."""
    return ((jump_steps + w.long() - 1) // w.long()).clamp(1, num_hashes)


def light_segments(B: int, n: int, n_sm: int,
                   tile: int = TILE) -> tuple[int, int]:
    """(seg, nseg): the light pass cuts each row into nseg segments of
    seg k-mers: one tile each (a block walks a tile's slots the same way
    whether it holds one tile or many, so this costs nothing), or, where
    that gives fewer than BLOCKS_PER_SM * n_sm blocks, whole sub-tiles of
    tile // 16 k-mers (one a thread) that make about that many."""
    target = BLOCKS_PER_SM * n_sm
    seg = tile
    if B * -(-n // tile) < target:
        sub = max(1, tile // 16)
        per_row = -(-n // -(-target // max(B, 1)))
        seg = min(tile, sub * max(1, -(-per_row // sub)))
    return seg, max(1, -(-n // seg))


def heavy_kmers(weight: torch.Tensor, active: torch.Tensor,
                heavy_min: int = HEAVY_MIN) -> torch.Tensor:
    """int64 [n_heavy]: row * n + column of the active k-mers of weight
    >= heavy_min, ascending (one host sync, for the count)."""
    heavy = active & (weight >= heavy_min)
    return torch.nonzero(heavy.reshape(-1))[:, 0]


def _check_rows(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{name}: want contiguous {dtype} {tuple(shape)} "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} "
                         f"on {t.device}")


def _cuda_only(h: torch.Tensor) -> None:
    if h.device.type != "cuda":
        raise ValueError(f"unsupported device {h.device}")


_consts: dict = {}


def _device_consts(dev: torch.device):
    """(SM count, jump table on dev, side stream), once per device."""
    if dev not in _consts:
        _consts[dev] = (
            torch.cuda.get_device_properties(dev).multi_processor_count,
            xorshift_jump_table().to(dev), torch.cuda.Stream(dev))
    return _consts[dev]


def plan(which: int, num_hashes: int, device=None) -> dict:
    """Where the running bests of kernel 1 (which = 1) or of kernel 2's
    light pass (which = 2) live at num_hashes slots on the card
    (``_build.plan``)."""
    return _build.plan("mhap_min_reduce_plan", which, num_hashes,
                       device=device)


def min_reduce_w1(h: torch.Tensor, active: torch.Tensor,
                  num_hashes: int) -> torch.Tensor:
    """Weight-1 min-reduce: h [B, n] int64, active [B, n] bool ->
    int32 [B, num_hashes]."""
    if h.device.type == "cpu":
        return min_reduce_w1_ref(h, active, num_hashes)
    _cuda_only(h)
    h = h.contiguous()
    active = active.to(torch.uint8).contiguous()
    B, n = h.shape
    _check_rows("h", h, torch.int64, (B, n), h.device)
    _check_rows("active", active, torch.uint8, (B, n), h.device)
    out = torch.empty((B, num_hashes), dtype=torch.int32, device=h.device)
    ws, grid = _build.workspace(plan(1, num_hashes, h.device), B, h.device)
    err = _build.kernels().mhap_min_reduce(
        h.data_ptr(), active.data_ptr(), B, n, num_hashes,
        None if ws is None else ws.data_ptr(), grid, out.data_ptr(),
        torch.cuda.current_stream(h.device).cuda_stream)
    _build.check(err, "min_reduce_w1")
    min_reduce_w1.launches += 1
    return out


def weighted_min_reduce(h: torch.Tensor, weight: torch.Tensor,
                        active: torch.Tensor, tiebreak: torch.Tensor,
                        num_hashes: int, *, heavy_min: int = HEAVY_MIN,
                        slab: int | None = None) -> torch.Tensor:
    """Weighted min-reduce, lexicographic (value, tiebreak) arg-min:
    h [B, n] int64, weight/tiebreak [B, n] int32, active [B, n] bool ->
    int32 [B, num_hashes].  Any weight and width.  ``launches`` counts
    one per call that launches the three passes.  The keywords are
    internal, for measurement and checks: the weight from which a k-mer
    is heavy (one past every weight runs the light pass alone) and the
    heavy k-mers a heavy-pass launch takes (HEAVY_CELLS // num_hashes, so
    that its scratch stays bounded however many there are)."""
    if h.device.type == "cpu":
        return weighted_min_reduce_ref(h, weight, active, tiebreak,
                                       num_hashes)
    _cuda_only(h)
    if num_hashes >= 1 << (JUMP_BITS - 31):
        raise ValueError(f"num_hashes {num_hashes}: a jump of w * slot "
                         f"steps must stay under 2^{JUMP_BITS}")
    dev = h.device
    h = h.contiguous()
    B, n = h.shape
    weight = weight.to(torch.int32).contiguous()
    tiebreak = tiebreak.to(torch.int32).contiguous()
    active = active.bool().contiguous()  # one byte of 0 or 1 a k-mer
    for name, t, dt in (("h", h, torch.int64),
                        ("weight", weight, torch.int32),
                        ("tiebreak", tiebreak, torch.int32),
                        ("active", active, torch.bool)):
        _check_rows(name, t, dt, (B, n), dev)
    n_sm, table, side = _device_consts(dev)
    H = num_hashes
    seg, nseg = light_segments(B, n, n_sm)
    part_v = torch.empty((B, nseg, H), dtype=torch.int64, device=dev)
    part_tb = torch.empty((B, nseg, H), dtype=torch.int32, device=dev)
    part_idx = torch.empty((B, nseg, H), dtype=torch.int32, device=dev)
    out = torch.empty((B, H), dtype=torch.int32, device=dev)
    ws, grid = _build.workspace(plan(2, H, dev), B * nseg, dev)
    lib = _build.kernels()
    main = torch.cuda.current_stream(dev)
    side.wait_stream(main)
    err = lib.mhap_weighted_light(
        h.data_ptr(), weight.data_ptr(), tiebreak.data_ptr(),
        active.data_ptr(), B, n, H, heavy_min, seg, nseg,
        None if ws is None else ws.data_ptr(), grid, part_v.data_ptr(),
        part_tb.data_ptr(), part_idx.data_ptr(), main.cuda_stream)
    _build.check(err, "weighted_min_reduce (light pass)")
    # the heavy k-mers are listed on a side stream, so that the host's wait
    # for their count, and its launches of the passes after, overlap the
    # light pass instead of following it
    with torch.cuda.stream(side), trace.span("sketch.wait"):
        flat = heavy_kmers(weight, active, heavy_min)
    main.wait_stream(side)
    flat.record_stream(main)
    stream = main.cuda_stream
    slab = slab or max(1, HEAVY_CELLS // H)
    heavy_v = torch.empty((min(len(flat), slab), H), dtype=torch.int64,
                          device=dev)
    for s0 in range(0, max(len(flat), 1), slab):
        last = s0 + slab >= len(flat)  # earlier slabs fold into partial 0
        part = flat[s0:s0 + slab]
        err = lib.mhap_weighted_heavy_fold(
            h.data_ptr(), weight.data_ptr(), tiebreak.data_ptr(), B, n, H,
            nseg, part.data_ptr(), len(part), JUMP_STEPS, table.data_ptr(),
            part_v.data_ptr(), part_tb.data_ptr(), part_idx.data_ptr(),
            heavy_v.data_ptr(), out.data_ptr() if last else None, stream)
        _build.check(err, "weighted_min_reduce (heavy and fold passes)")
    weighted_min_reduce.launches += 1
    return out


min_reduce_w1.launches = 0
weighted_min_reduce.launches = 0
