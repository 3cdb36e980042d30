"""Wrapper of the CUDA pair-scorer kernel (``csrc/scorer.cu``), which
replaces ``score_pairs_pallas`` (mhap_tpu/ops/scorer_pallas.py:471).

The kernel scores one pair a block of 256 threads and reads the store's
[N, S] columns directly by the ``qi``/``ci`` row indices.  Every stage of
getOverlapInfo runs across the block: a merge path pairs each run of
equal hashes in the query row with the candidate's; each recordMatching
pass runs one automaton a run pair, writing to slots that a compaction
packs in hash order; medians by radix select; optimizeShifts as a
segmented arg-min; block reductions for the UMVU edges; the windowed
Jaccard from ranks and a prefix sum.  Its scratch lives in shared memory
(36.4 KB at S = 1536, so 6 blocks share an SM) while S <= 65,535 and the
footprint fits the card's opt-in limit a block (S up to about 9,900 on
the H100); above that, in a device-memory workspace allocated here, one
slice for each of a grid of resident blocks that loop over the pairs
(``_build.workspace``), with 32-bit indices, for any S up to 268,435,455 (``plan`` says which
path S takes; ``occupancy`` reports what the card gives).  For CPU
tensors the wrapper gathers the rows and runs the plain version
``ops/scorer.score_pairs_ref``; for CUDA tensors it launches the kernel
or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .scorer import N_COLS, score_pairs_ref


def score_pairs(q_cols, c_cols, qi: torch.Tensor, ci: torch.Tensor,
                max_shift: float) -> torch.Tensor:
    """Score pairs (q row qi[t], c row ci[t]).

    q_cols, c_cols: (ordered_h [N, S], ordered_p [N, S], ordered_m [N],
    num_kmers [N]) int32 store columns.  Returns int32 [T, 16]
    (``ops/scorer.COLS``)."""
    qoh, qop, qom, qnk = q_cols
    coh, cop, com, cnk = c_cols
    dev = qoh.device
    if dev.type == "cpu":
        qi, ci = qi.long(), ci.long()
        return score_pairs_ref(qoh[qi], qop[qi], qom[qi], qnk[qi],
                               coh[ci], cop[ci], com[ci], cnk[ci],
                               max_shift)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    S = qoh.shape[1]
    for name, t, shape in (("q_oh", qoh, (qoh.shape[0], S)),
                           ("q_op", qop, (qoh.shape[0], S)),
                           ("q_om", qom, (qoh.shape[0],)),
                           ("q_nk", qnk, (qoh.shape[0],)),
                           ("c_oh", coh, (coh.shape[0], S)),
                           ("c_op", cop, (coh.shape[0], S)),
                           ("c_om", com, (coh.shape[0],)),
                           ("c_nk", cnk, (coh.shape[0],))):
        if (t.dtype != torch.int32 or tuple(t.shape) != shape
                or not t.is_contiguous() or t.device != dev):
            raise ValueError(f"{name}: want contiguous int32 {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    qi = qi.to(device=dev, dtype=torch.int32).contiguous()
    ci = ci.to(device=dev, dtype=torch.int32).contiguous()
    T = qi.shape[0]
    out = torch.empty((T, N_COLS), dtype=torch.int32, device=dev)
    if T == 0:
        return out
    ws, grid = _build.workspace(plan(S, dev), T, dev)
    err = _build.kernels().mhap_score_pairs(
        qoh.data_ptr(), qop.data_ptr(), qom.data_ptr(), qnk.data_ptr(),
        coh.data_ptr(), cop.data_ptr(), com.data_ptr(), cnk.data_ptr(),
        qi.data_ptr(), ci.data_ptr(), T, S, float(max_shift),
        None if ws is None else ws.data_ptr(), grid, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "score_pairs")
    score_pairs.launches += 1
    return out


score_pairs.launches = 0

def plan(S: int, device=None) -> dict:
    """Where the kernel's scratch lives at sketch size S on the card
    (``_build.plan``: dynamic shared memory, or a workspace slice)."""
    return _build.plan("mhap_score_pairs_plan", S, device=device)


def occupancy(S: int) -> dict:
    """The registers a thread, static / dynamic shared bytes a block,
    local (spill) bytes a thread and resident blocks per SM of the kernel
    that takes sketch size S, as the CUDA runtime reports them."""
    info = (ctypes.c_int * 5)()
    _build.check(_build.kernels().mhap_score_pairs_occupancy(
        S, ctypes.addressof(info)), "score_pairs occupancy")
    return dict(zip(("registers", "static_smem", "dynamic_smem",
                     "local_bytes", "blocks_per_sm"), info))
