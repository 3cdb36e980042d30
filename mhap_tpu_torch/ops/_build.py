"""Build and load the port's CUDA kernels (``mhap_tpu_torch/csrc/*.cu``).

Each source compiles with its own ``nvcc`` for ``sm_90a``, all at once;
the objects link into one shared library with a plain C interface,
loaded with ``ctypes``.  The library lands in
``mhap_tpu_torch/build/``, named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads at once.  Nothing here
runs at import time: the first CUDA launch calls ``kernels()``.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``check()`` raises if that is not 0.  A kernel
whose scratch can outgrow shared memory has a plan entry: ``plan()``
reads which path a size takes on the card, ``workspace()`` allocates the
device-memory path's scratch (kernels allocate nothing).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
# --fmad=false: the scorer's (int)(overlap * max_shift) must be the plain
# IEEE double product of the Java reference
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "--fmad=false"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# C signatures, all returning the launch's cudaError_t as int
SIGNATURES = {
    "mhap_min_reduce": [_P, _P, _I, _I, _I, _P, _I, _P, _P],
    "mhap_min_reduce_plan": [_I, _I, _P],
    "mhap_weighted_light": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I,
                            _P, _P, _P, _P],
    "mhap_weighted_heavy_fold": [_P, _P, _P, _I, _I, _I, _I, _P, _I, _I, _P,
                                 _P, _P, _P, _P, _P, _P],
    "mhap_score_pairs": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                         ctypes.c_double, _P, _I, _P, _P],
    "mhap_score_pairs_plan": [_I, _P],
    "mhap_score_pairs_occupancy": [_I, _P],
    "mhap_merge2": [_P, _P, _P, _P, _I, _I, _I, _P, _P, _P],
    "mhap_merge2_occupancy": [_I, _I, _P],
    "mhap_sw_align_batch": [_P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _P, _P, _P, _P],
    "mhap_sw_align_occupancy": [_I, _P],
    "mhap_bit_similarity": [_P, _P, _I, _I, _I, _I, _P, _P],
    "mhap_bit_similarity_occupancy": [_I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the nvcc run, None if loaded cached


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _flags() -> list[str]:
    """NVCC_FLAGS and the shapes the sources take from their wrappers, so
    each is kept in one place: kernel 5's block (ops/swalign_kernels.py
    WARPS and ROWS)."""
    from . import swalign_kernels as swk

    return [*NVCC_FLAGS, f"-DMHAP_SW_WARPS={swk.WARPS}",
            f"-DMHAP_SW_ROWS={swk.ROWS}"]


def library_path() -> str:
    h = hashlib.sha256(" ".join(_flags()).encode())
    for p in _sources():
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"libmhap_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless the library for their hash exists."""
    global build_seconds
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc, flags = _nvcc(), _flags()
    tmp = tempfile.mkdtemp(dir=BUILD_DIR)
    t0 = time.perf_counter()
    try:
        jobs = []
        for src in (p for p in _sources() if p.endswith(".cu")):
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            jobs.append((src, obj, subprocess.Popen(
                [nvcc, *flags, "-c", src, "-o", obj],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        errors = []
        for src, _obj, proc in jobs:
            _out, err = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{os.path.basename(src)} "
                              f"({proc.returncode}):\n{err}")
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        lib = os.path.join(tmp, "lib.so")
        r = subprocess.run([nvcc, "-shared", "-o", lib,
                            *[obj for _src, obj, _p in jobs]],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({r.returncode}):\n"
                               f"{r.stderr}")
        os.replace(lib, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0
    return out


def kernels() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, args in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            lib.mhap_error_string.argtypes = [ctypes.c_int]
            lib.mhap_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        msg = kernels().mhap_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


WORKSPACE_BYTES = 1 << 30  # a device-memory path's scratch, at most
_plans: dict = {}


def plan(entry: str, *args, device=None) -> dict:
    """The C plan entry ``entry(*args, info)`` on the card: ``path``
    "shared" or "device" (memory of the kernel's scratch), ``bytes`` of
    scratch a block and ``resident_blocks`` of that kernel on the card."""
    dev = torch.device(device or "cuda")
    key = (dev, entry, args)
    if key not in _plans:
        with torch.cuda.device(dev):
            info = (ctypes.c_longlong * 3)()
            check(getattr(kernels(), entry)(*args, ctypes.addressof(info)),
                  f"{entry}{args}")
        _plans[key] = dict(path=("shared", "device")[info[0]],
                           bytes=info[1], resident_blocks=info[2])
    return _plans[key]


def workspace(p: dict, blocks: int, device):
    """(scratch tensor or None, grid) of a launch of ``blocks`` blocks on
    plan ``p``: none on the shared path; else one slice a block for a
    grid of the card's resident blocks, or fewer, within
    WORKSPACE_BYTES."""
    if p["path"] == "shared":
        return None, 0
    grid = max(1, min(blocks, p["resident_blocks"],
                      WORKSPACE_BYTES // p["bytes"]))
    return torch.empty(grid * p["bytes"], dtype=torch.uint8,
                       device=device), grid
