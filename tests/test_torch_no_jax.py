"""The port stands without JAX and without the JAX package: imports, a
small CPU run (unfiltered, filtered, a --supress-noise 2 sketch with
the bloom filter through a .dat file, a one-rank sharded run, an
EstimateROC estimate whose disputed pair goes through the batched
Smith-Waterman, the numpy oracle's overlap_self and a CPU
bit_similarity_matrix) with both blocked, an import scan
of its sources, the device check, and chip_smoke.py's refusal to run
without a GPU or the repo."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_NO_JAX_RUN = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
sys.modules["mhap_tpu"] = None  # so does any import of the JAX package
import importlib, pkgutil
import mhap_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mhap_tpu_torch.__path__,
                                               "mhap_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import numpy as np
from mhap_tpu_torch.ops.minhash_kernels import (min_reduce_w1,
                                                weighted_min_reduce)
from mhap_tpu_torch.ops.scorer_kernels import score_pairs
from mhap_tpu_torch.io.filter import FrequencyCounts
from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper
rng = np.random.default_rng(3)
genome = rng.integers(0, 4, 6000)
base = np.frombuffer(b"ACGT", np.uint8)
reads = [bytes(base[genome[s:s + 2500]]).decode() for s in (0, 700, 1500, 3000)]
cfg = dict(num_hashes=64, ordered_sketch_size=256)
lines = TorchOverlapper(cfg, device="cpu").overlap_self(reads)
assert len(lines) >= 3, lines
kmers = [reads[0][i:i + 16] for i in range(0, 400, 20)]
fc = FrequencyCounts(["20 20"] + [f"{k} 0.001" for k in kmers], 1e-5, 0.9,
                     0, False, 3.0, True)
filt = TorchOverlapper(cfg, device="cpu", kmer_filter=VectorFrequencyFilter(
    fc, "cpu")).overlap_self(reads)
assert len(filt) >= 3 and filt != lines, filt
import os, tempfile
from mhap_tpu_torch.io import datstore
fc2 = FrequencyCounts(["20 20"] + [f"{k} 0.001" for k in kmers], 1e-5, 0.9,
                      2, False, 3.0, True, use_bloom=True)
store = TorchOverlapper(cfg, device="cpu", kmer_filter=VectorFrequencyFilter(
    fc2, "cpu")).sketch_reads(reads)
with tempfile.TemporaryDirectory() as td:
    datstore.write_dat(os.path.join(td, "x.dat"), store)
    back = datstore.read_dat(os.path.join(td, "x.dat"), sketch_size=256,
                             device="cpu")
assert (back.host("minhash") == store.host("minhash")).all() and len(back)
from mhap_tpu_torch.parallel import comm
from mhap_tpu_torch.parallel.sharded import ShardedOverlapper
with comm.single("gloo", "cpu") as c:
    assert ShardedOverlapper(c, cfg).overlap_self(reads) == lines
from mhap_tpu_torch.ops.swalign_kernels import sw_align_batch
from mhap_tpu_torch.tools.estimate_roc import EstimateROC
with tempfile.TemporaryDirectory() as td:
    fa, truth, ovl = (os.path.join(td, n) for n in ("r.fa", "t.m4", "o.mhap"))
    with open(fa, "w") as f:
        f.writelines(f">{i + 1}\n{r}\n" for i, r in enumerate(reads))
    with open(truth, "w") as f:  # read 1 (genome 0) placed at 20000
        f.writelines(f"{i + 1} chr1 -2500 95.0 0 0 2500 2500 0 {s} "
                     f"{s + 2500} 30000 254\n"
                     for i, s in enumerate((20000, 700, 1500, 3000)))
    with open(ovl, "w") as f:  # 1 kb of each true overlap
        f.write("1 2 0.1 10 0 700 1700 2500 0 0 1000 2500\n"
                "2 3 0.1 10 0 800 1800 2500 0 0 1000 2500\n")
    roc = EstimateROC(min_ovl_len=200, num_trials=10, do_dp=True,
                      device="cpu")
    roc.process_reference(truth)
    roc.load_fasta(fa)
    roc.process_overlaps(ovl)
    roc.estimate_sensitivity()
    roc.estimate_specificity()
    batch, seen = roc._compute_dp_batch, []
    roc._compute_dp_batch = lambda pairs: (seen.append(len(pairs)),
                                           batch(pairs))[1]
    roc.estimate_ppv(batch_dp=True)  # pair 1-2 disputed, then rescued
assert seen and seen[0] > 0 and roc.ppv == 1.0, (seen, roc.ppv)
assert roc.tp + roc.fn > 0 and roc.tn + roc.fp > 0
from mhap_tpu_torch.oracle.pipeline import overlap_self
assert overlap_self(reads, cfg) == lines
from mhap_tpu_torch.ops.bits_kernels import bit_similarity
from mhap_tpu_torch.sketches.bits import (MinHashBitSketch,
                                          bit_similarity_matrix)
bits = np.stack([MinHashBitSketch(r[:600], 12, 2).bits for r in reads])
sim = bit_similarity_matrix(bits, bits, device="cpu")
assert sim.shape == (4, 4) and (sim.diagonal() == 1).all()
assert float(sim[0, 1]) == MinHashBitSketch(bits[0]).similarity(
    MinHashBitSketch(bits[1]))
assert (min_reduce_w1.launches, weighted_min_reduce.launches,
        score_pairs.launches, sw_align_batch.launches,
        bit_similarity.launches) == (0, 0, 0, 0, 0)
assert not any(m.split(".")[0] in ("jax", "mhap_tpu")
               and sys.modules[m] is not None for m in sys.modules)
print(len(names), len(lines))
"""


def test_port_imports_and_runs_without_jax():
    r = subprocess.run([sys.executable, "-c", _NO_JAX_RUN], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    n_modules, n_lines = map(int, r.stdout.split())
    assert n_modules >= 40 and n_lines >= 3


def imported_roots(path: str) -> set:
    """Top-level package of every absolute import in a source file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def port_sources() -> list:
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "profile_stages.py"),
             os.path.join(REPO, "scripts", "torch_scale_check.py"),
             os.path.join(REPO, "scripts", "scale_goldens.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "mhap_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def test_no_jax_import_in_port_sources():
    for path in port_sources():
        assert "jax" not in imported_roots(path), path


def test_no_jax_package_import_in_port_sources():
    """Not even the JAX package's modules that import no JAX: the port
    keeps its own copies (``mhap_tpu_torch`` itself is a different
    root)."""
    files = port_sources()
    assert len(files) >= 25
    for path in files:
        assert "mhap_tpu" not in imported_roots(path), path


def test_cuda_device_without_gpu_raises():
    from mhap_tpu_torch.device import resolve_device
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        TorchOverlapper(device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_chip_smoke_refuses_without_gpu_or_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the smoke would run for real")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""
