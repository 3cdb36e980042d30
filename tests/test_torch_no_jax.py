"""The port stands without JAX: imports, a small CPU run, the device
check, and chip_smoke.py's refusal to run without a GPU or the repo."""

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
from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper
rng = np.random.default_rng(3)
genome = rng.integers(0, 4, 6000)
base = np.frombuffer(b"ACGT", np.uint8)
reads = [bytes(base[genome[s:s + 2500]]).decode() for s in (0, 700, 1500, 3000)]
lines = TorchOverlapper(dict(num_hashes=64, ordered_sketch_size=256),
                        device="cpu").overlap_self(reads)
assert len(lines) >= 3, lines
assert (min_reduce_w1.launches, weighted_min_reduce.launches,
        score_pairs.launches) == (0, 0, 0)
assert not any(m.startswith("jax") and sys.modules[m] is not None
               for m in sys.modules)
print(len(names), len(lines))
"""


def test_port_imports_and_runs_without_jax():
    r = subprocess.run([sys.executable, "-c", _NO_JAX_RUN], cwd=REPO,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=REPO))
    assert r.returncode == 0, r.stderr[-3000:]
    n_modules, n_lines = map(int, r.stdout.split())
    assert n_modules >= 14 and n_lines >= 3


def test_no_jax_import_in_port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(os.path.join(REPO, "mhap_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as f:
            for line in f:
                s = line.strip()
                assert not (s.startswith("import jax")
                            or s.startswith("from jax")), (path, s)


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
