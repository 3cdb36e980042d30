"""Sequence utilities of the oracle (the port's copy of
mhap_tpu/oracle/seq.py).

Parity target: utils/Utils.java rc()/Translate (:84-117, :496-507) --
reverse complement with IUPAC codes; unknown characters map to themselves.
``reverse_complement`` is the port's one copy, in ``utils/seq.py``.
"""

from __future__ import annotations

from ..utils.seq import _RC_TABLE, reverse_complement

__all__ = ["reverse_complement", "rc_bytes"]


def rc_bytes(seq: bytes) -> bytes:
    return seq.translate(_RC_TABLE)[::-1]
