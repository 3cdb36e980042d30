#!/usr/bin/env python3
"""Smoke check of the port on one CUDA card: the main path once, then each
kernel against its plain version on that run's inputs, timed.

    python3 chip_smoke.py

Runs ``TorchOverlapper(device="cuda").overlap_self`` on the primary
workload (bench.make_reads, 2,048 reads of 2,900 bases) with the kernels'
launch counters reset just before, and checks its line count and that the
path's kernels (the strand pack, kernels 1 and 3) launched.  Then, on
inputs from that run, each kernel wrapper against its plain version: the
strand pack on the reads' strands, kernel 1 on the first 512 reads' 16-mer
hashes, kernel 2 on the reads' repeat rows, kernels 3 and 4 on the first
4,096 candidate pairs, kernel 5 on the overlap regions of the first 256
lines and kernel 6 on the reads' 1-bit sketches all against all.  Each is
timed through its wrapper (scripts/kernel_ab.py's ``time_ms``: CUDA
events, median of 5 after a warm-up) beside its bound (``kernel_ab.bound``)
and its plain version's one synchronised run, and kernels 4 and 6 beside a
library call the port never makes (``library_ms``: ``torch.sort`` of the
packed keys, an fp16 matmul of the unpacked bits).

Prints the ``{"kernels": [...]}`` JSON line (``launches`` counts the main
path's run), the card's nvidia-smi name and power limit, and ``{"ok":
true, "device": ...}``.  Exits 1 when a check fails, 2 without a card or
outside a checkout.  The full checks on the card are the ``cuda`` tests
(README); this script takes about a minute.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
K1, H, S, PAIRS, SW_PAIRS = 16, 512, 1536, 4096, 256
# kernel -> (its source, what it replaces in the JAX package)
SOURCES = {
    "pack_strands": ("mhap_tpu_torch/csrc/pack.cu",
                     "none (the JAX package makes the rc strand with XLA "
                     "ops, mhap_tpu/pipeline/overlapper.py:885-891)"),
    "min_reduce_w1": ("mhap_tpu_torch/csrc/minhash.cu",
                      "mhap_tpu/ops/minhash_pallas.py:156"),
    "weighted_min_reduce": ("mhap_tpu_torch/csrc/minhash.cu",
                            "mhap_tpu/ops/minhash_pallas.py:193"),
    "score_pairs": ("mhap_tpu_torch/csrc/scorer.cu",
                    "mhap_tpu/ops/scorer_pallas.py:471"),
    "merge2": ("mhap_tpu_torch/csrc/merge.cu",
               "mhap_tpu/ops/merge_pallas.py:117 (no caller on the overlap "
               "path, as in JAX)"),
    "sw_align_batch": ("mhap_tpu_torch/csrc/swalign.cu",
                       "mhap_tpu/ops/swalign.py:37 (a lax.scan, not a "
                       "Pallas kernel)"),
    "bit_similarity_matrix": ("mhap_tpu_torch/csrc/bits.cu",
                              "mhap_tpu/sketches/bits.py:137 "
                              "(jax.lax.population_count, not a Pallas "
                              "kernel)")}
# the kernels the main path launches on the primary workload
PATH = ("pack_strands", "min_reduce_w1", "score_pairs")


def max_abs_err(got, want) -> float:
    """Largest |got - want| over a kernel's outputs (a tensor, or a tuple
    or dict of them), in float64; inf where a shape or a NaN differs."""
    import torch

    if isinstance(got, torch.Tensor):
        got, want = [got], [want]
    elif isinstance(got, dict):
        got, want = [got[k] for k in sorted(got)], [want[k] for k in
                                                    sorted(got)]
    err = 0.0
    for g, w in zip(got, want, strict=True):
        if g.shape != w.shape:
            return float("inf")
        if g.numel() and not torch.equal(g, w):
            d = (g.long() - w.long() if not g.is_floating_point()
                 else g.double() - w.double()).abs().max()
            err = max(err, float(d) if float(d) == float(d) else
                      float("inf"))
    return err


def once_ms(fn):
    """fn()'s result and the ms of one synchronised run of it."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def sw_inputs(reads, lines, n: int, dev):
    """sw_align_batch's arguments on the overlap regions of the first n
    M4 lines, packed as EstimateROC packs its disputed pairs."""
    import torch

    from mhap_tpu_torch.ops.swalign import pack_pairs
    from mhap_tpu_torch.utils.seq import reverse_complement

    pairs = []
    for line in lines[:n]:
        f = line.split()
        a = reads[int(f[0]) - 1][int(f[5]):int(f[6])]
        b = reads[int(f[1]) - 1][int(f[9]):int(f[10])]
        pairs.append((a.encode(), (reverse_complement(b) if f[8] != "0"
                                   else b).encode()))
    return [torch.from_numpy(x).to(dev) for x in pack_pairs(pairs)]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "mhap_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(mhap_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path[:0] = [REPO, os.path.join(REPO, "tests"),
                    os.path.join(REPO, "scripts")]
    import bench
    import kernel_ab as ab
    import torch_card_inputs as ci
    from mhap_tpu_torch.ops import bits, merge, minhash, pack, scorer, swalign
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper
    from mhap_tpu_torch.sketches.bits import pack_last_bits_msb_first

    dev = torch.device("cuda")
    kern = ci.kernels()
    reads = bench.make_reads()
    ov = TorchOverlapper(device="cuda")
    ci.reset_counters(kern)
    t0 = time.perf_counter()
    lines = ov.overlap_self(reads)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ci.read_counters(kern)
    failures = [f"{k} did not launch" for k in PATH if launches[k] == 0]
    if len(lines) != ci.EXPECTED_PRIMARY:
        failures.append(f"{len(lines)} lines, not {ci.EXPECTED_PRIMARY}")
    print(f"primary: {len(lines)} lines in {wall:.3f} s (cold), launches "
          f"{launches}", file=sys.stderr)

    store, qg, cand = ci.candidate_pairs(ov, reads)
    qi, cj = (torch.from_numpy(x[:PAIRS].astype(np.int32)).to(dev)
              for x in (qg, cand))
    cols = store.scorer_cols()
    gathered = [c[qi.long()] for c in cols] + [c[cj.long()] for c in cols]
    ma = ci.merge_rows(store, qi) + ci.merge_rows(store, cj)
    packed = torch.cat([merge.pack_keys(*ma[:2]), merge.pack_keys(*ma[2:])],
                       dim=1)
    words = pack_last_bits_msb_first(
        store.host("minhash")[store.header_id != 0])
    kw = bits.words(words, dev)
    unpacked = ab.unpacked_bits(words, dev)
    h = ci.primary_hashes(reads, 512, dev, K1)
    act = torch.ones_like(h, dtype=torch.bool)
    w2 = ci.weighted_inputs(*ci.code_rows(ci.repeat_rows(reads), K1, dev))
    pa = ab.pack_args(reads, dev)
    sw = sw_inputs(reads, lines, SW_PAIRS, dev)
    # name -> (kernel call, plain call, its work, library call or None)
    cases = {
        "pack_strands": (lambda: kern["pack_strands"](*pa),
                         lambda: pack.pack_strands_ref(*pa),
                         ab.pack_work(*pa), None),
        "min_reduce_w1": (lambda: kern["min_reduce_w1"](h, act, H),
                          lambda: minhash.min_reduce_w1_ref(h, act, H),
                          ab.k1_work(h, act, H), None),
        "weighted_min_reduce": (
            lambda: kern["weighted_min_reduce"](*w2, H),
            lambda: minhash.weighted_min_reduce_ref(*w2, H),
            ab.k2_work(*w2, H), None),
        "score_pairs": (lambda: kern["score_pairs"](cols, cols, qi, cj, 0.2),
                        lambda: scorer.score_pairs_ref(*gathered, 0.2),
                        ab.k3_work(cols, qi, cj), None),
        "merge2": (lambda: kern["merge2"](*ma, out_width=2 * S),
                   lambda: merge.merge2_ref(*ma, 2 * S),
                   ab.k4_work(*ma, 2 * S),
                   lambda: torch.sort(packed, dim=1)),
        "sw_align_batch": (lambda: kern["sw_align_batch"](*sw),
                           lambda: swalign.sw_align_batch(*sw),
                           ab.k5_work(*sw), None),
        "bit_similarity_matrix": (
            lambda: kern["bit_similarity_matrix"](kw, kw),
            lambda: bits.bit_similarity_ref(kw, kw),
            ab.k6_work(words, words), lambda: unpacked @ unpacked.T)}
    entries = []
    for name, (run, plain, work, library) in cases.items():
        want, plain_ms = once_ms(plain)
        err = max_abs_err(run(), want)
        del want
        if err:
            failures.append(f"{name} differs from its plain version")
        entries.append(
            {"name": name, "route": "cuda", "source": SOURCES[name][0],
             "replaces": SOURCES[name][1], "launches": launches[name],
             "max_abs_err": err, **ab.timed(ab.time_ms(run), *work),
             "plain_ms": plain_ms,
             "library_ms": ab.time_ms(library) if library else None})
    print(json.dumps({"kernels": entries}))
    print(ab.nvidia_smi())
    bad_mods = [m for m in sys.modules
                if m.split(".")[0] in ("jax", "mhap_tpu")]
    if bad_mods:
        failures.append(f"imported {bad_mods[:5]}")
    if failures:
        print(f"chip_smoke: {failures}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
