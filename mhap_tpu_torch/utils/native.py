"""ctypes binding of the repository's native C++ library
(``native/build/libmhapnative.so``), built with ``make -C native`` on
first use.  The port takes one function from it, the bulk M4 formatter;
``library()`` hands the loaded library to callers that declare other
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
