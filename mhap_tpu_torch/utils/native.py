"""ctypes bindings of the host C++ the port calls.

The repository's native library (``native/build/libmhapnative.so``),
built with ``make -C native`` on first use, gives the port the local
Smith-Waterman of EstimateROC's per-pair adjudication (native/sw.cc) and
canonical MurmurHash3 x86_32 over a byte string (native/murmur3.c;
CountMin's object hashing); ``library()`` hands the loaded library to
callers that declare other entries themselves (chip_smoke.py's native
scorer check).

The port's own M4 line library (``mhap_tpu_torch/csrc/m4_lines.cc``)
formats and sorts a job's M4 lines as one byte buffer
(``m4_format``, ``m4_sort``).  It is built with the host's C++ compiler
(``$CXX``, else ``g++``) on first use into ``mhap_tpu_torch/build/``,
named by a hash of the source, so an edited source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from functools import lru_cache

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(os.path.dirname(_PKG), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libmhapnative.so")
_M4_SRC = os.path.join(_PKG, "csrc", "m4_lines.cc")
_M4_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-Wall"]


@lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    if not os.path.exists(_LIB_PATH):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(_LIB_PATH)
    lib.mhap_sw_align.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.mhap_sw_align.restype = ctypes.c_int
    lib.murmur3_x86_32.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_uint32]
    lib.murmur3_x86_32.restype = ctypes.c_uint32
    return lib


@lru_cache(maxsize=1)
def m4_library() -> ctypes.CDLL:
    """The M4 line library, built on first call unless the library for
    the source's hash exists."""
    with open(_M4_SRC, "rb") as f:
        h = hashlib.sha256(" ".join(_M4_FLAGS).encode() + b"\0" + f.read())
    build = os.path.join(_PKG, "build")
    path = os.path.join(build, f"libm4_lines_{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(build, exist_ok=True)
        tmp = tempfile.mkdtemp(dir=build)
        try:
            lib = os.path.join(tmp, "lib.so")
            r = subprocess.run([os.environ.get("CXX", "g++"), *_M4_FLAGS,
                                _M4_SRC, "-o", lib],
                               capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"building {_M4_SRC} failed "
                                   f"({r.returncode}):\n{r.stderr}")
            os.replace(lib, path)  # whole, or not at all
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    lib = ctypes.CDLL(path)
    lib.mhap_m4_format.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
    lib.mhap_m4_format.restype = ctypes.c_longlong
    lib.mhap_m4_sort.argtypes = [ctypes.c_void_p, ctypes.c_longlong,
                                 ctypes.c_void_p, ctypes.c_int]
    lib.mhap_m4_sort.restype = ctypes.c_longlong
    return lib


M4_LINE_GUESS = 160  # bytes a line the first buffer allows
M4_LINE_MAX = 1024   # the longest line m4_lines.cc can write


def host_threads() -> int:
    """The CPUs this process may run on: the M4 line library's threads
    (it starts one for every 16,384 lines at most)."""
    return len(os.sched_getaffinity(0))


def m4_format(qid, cid, err, raw, qrc, a1, a2, ql, crc, b1, b2, cl,
              threads=None) -> np.ndarray:
    """The M4 lines (MatchResult.java:98-113) of the columns, each ended
    by a newline, as one uint8 buffer; byte-equal to the Python %-format
    loop (``csrc/m4_lines.cc``).  ``threads``: at most that many threads
    (default ``host_threads()``)."""
    n = len(qid)
    ints = [np.ascontiguousarray(c, dtype=np.int64)
            for c in (qid, cid, qrc, a1, a2, ql, crc, b1, b2, cl)]
    err = np.ascontiguousarray(err, dtype=np.float64)
    raw = np.ascontiguousarray(raw, dtype=np.float64)
    if not all(len(c) == n for c in (*ints, err, raw)):
        raise ValueError("M4 columns of unequal lengths")
    qid, cid, qrc, a1, a2, ql, crc, b1, b2, cl = ints
    cols = [c.ctypes.data for c in
            (qid, cid, err, raw, qrc, a1, a2, ql, crc, b1, b2, cl)]
    for per_line in (M4_LINE_GUESS, M4_LINE_MAX):
        # the pages of the buffer past the lines are never touched
        buf = np.empty(n * per_line + M4_LINE_MAX, dtype=np.uint8)
        total = m4_library().mhap_m4_format(
            *cols, n, buf.ctypes.data, buf.size, threads or host_threads())
        if total >= 0:
            return buf[:total]
    raise RuntimeError("mhap_m4_format: buffer overflow")


def m4_sort(data: np.ndarray, threads=None) -> np.ndarray:
    """The newline-terminated lines of the uint8 buffer ``data`` in the
    order Python's ``sorted`` gives their ``str`` (byte order for UTF-8),
    on at most ``threads`` threads (default ``host_threads()``)."""
    data = np.ascontiguousarray(data, dtype=np.uint8)
    out = np.empty_like(data)
    if data.size and m4_library().mhap_m4_sort(
            data.ctypes.data, data.size, out.ctypes.data,
            threads or host_threads()) < 0:
        raise ValueError("M4 lines must each end with a newline")
    return out


def sw_align(query: bytes, ref: bytes, match: int = 2, mismatch: int = -2,
             gap_open: int = 2, gap_extend: int = 1, band: int = -1) -> dict:
    """Local affine-gap alignment (native/sw.cc mhap_sw_align): score,
    0-based inclusive begin/end coordinates, matches, errors, length (M+I+D
    columns) and identity = 1 - errors / length."""
    q = np.frombuffer(query, dtype=np.uint8)
    r = np.frombuffer(ref, dtype=np.uint8)
    out = np.zeros(8, dtype=np.int64)
    rc = library().mhap_sw_align(q.ctypes.data, len(q), r.ctypes.data,
                                 len(r), match, mismatch, gap_open,
                                 gap_extend, band, out.ctypes.data)
    if rc != 0:
        raise RuntimeError("mhap_sw_align failed")
    score, qb, qe, rb, re_, matches, errors, length = (int(x) for x in out)
    identity = 1.0 - errors / length if length > 0 else 0.0
    return {
        "score": score, "q_begin": qb, "q_end": qe, "r_begin": rb,
        "r_end": re_, "matches": matches, "errors": errors,
        "length": length, "identity": identity,
    }


def murmur3_x86_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86_32 of ``data`` as an unsigned int."""
    buf = (np.frombuffer(data, dtype=np.uint8) if data
           else np.zeros(1, dtype=np.uint8))
    return int(library().murmur3_x86_32(buf.ctypes.data, len(data),
                                        seed & 0xFFFFFFFF))
