"""ctypes binding of the repository's native C++ library
(``native/build/libmhapnative.so``), built with ``make -C native`` on
first use.  The port takes three functions from it: the bulk M4
formatter, the local Smith-Waterman of EstimateROC's per-pair adjudication
(native/sw.cc), and canonical MurmurHash3 x86_32 over a byte string
(native/murmur3.c; CountMin's object hashing); ``library()`` hands the loaded library to callers that declare other
entries themselves (chip_smoke.py's native scorer check).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from functools import lru_cache

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libmhapnative.so")


@lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    if not os.path.exists(_LIB_PATH):
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
    lib = ctypes.CDLL(_LIB_PATH)
    lib.mhap_format_m4.argtypes = [ctypes.c_void_p] * 12 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong]
    lib.mhap_format_m4.restype = ctypes.c_longlong
    lib.mhap_sw_align.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.mhap_sw_align.restype = ctypes.c_int
    lib.murmur3_x86_32.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_uint32]
    lib.murmur3_x86_32.restype = ctypes.c_uint32
    return lib


def format_m4(qid, cid, err, raw, qrc, a1, a2, ql, crc, b1, b2, cl):
    """Bulk M4 line formatting (MatchResult.java:98-113) in C, byte-equal
    to the Python %-format loop (native/format_m4.cc).  Returns a
    list[str]."""
    n = len(qid)
    if n == 0:
        return []

    def col(a, dtype):
        return np.ascontiguousarray(a, dtype=dtype)

    cols = (col(qid, np.int64), col(cid, np.int64), col(err, np.float64),
            col(raw, np.float64), col(qrc, np.int32), col(a1, np.int64),
            col(a2, np.int64), col(ql, np.int64), col(crc, np.int32),
            col(b1, np.int64), col(b2, np.int64), col(cl, np.int64))
    buf = np.empty(n * 192, dtype=np.uint8)
    total = library().mhap_format_m4(
        *[c.ctypes.data for c in cols], n, buf.ctypes.data, buf.size)
    if total < 0:
        raise RuntimeError("mhap_format_m4 buffer overflow")
    return buf[:total].tobytes().decode("ascii").split("\n")


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
