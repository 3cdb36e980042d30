"""Reverse complement as the reference computes it (the port's copy of
mhap_tpu/oracle/seq.py).

Parity target: utils/Utils.java rc()/Translate (:84-117, :496-507):
IUPAC aware, unknown characters map to themselves.  The overlapper's
``_rc_codes`` works on 2-bit codes and is not this function.
"""

from __future__ import annotations

_TRANSLATE = {
    "A": "T", "B": "V", "C": "G", "D": "H", "G": "C", "H": "D",
    "K": "M", "M": "K", "N": "N", "R": "Y", "S": "S", "T": "A",
    "V": "B", "W": "W", "Y": "R",
}

_RC_TABLE = bytes(
    ord(_TRANSLATE.get(chr(c), chr(c))) for c in range(256)
)


def reverse_complement(seq: str) -> str:
    """Utils.rc: reverse and complement, IUPAC aware, unknowns unchanged."""
    return seq.encode("ascii").translate(_RC_TABLE)[::-1].decode("ascii")
