"""Peak rates of the cards the benchmark knows, and the least time a
kernel's work can take on one (its roofline bound).

H100 SXM (NVIDIA data sheet and white paper): 3.35 TB/s of HBM3; INT32
operations at 132 SMs x 64 lanes x the 1,980 MHz maximum SM clock =
16.727 T op/s.  Frozen from ``chip_smoke.py`` (``MEM_BYTES_PER_S``,
``INT32_LANES_PER_SM``, ``sm_rate`` and ``bound``).  A card that is not in
the table has no roofline: its metrics are left out.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bytes_per_s": 3.35e12,
        "int32_ops_per_s": 132 * 64 * 1980e6,
    },
}


def bound_s(card: str, nbytes: float, nops: float) -> float | None:
    """max(bytes / bandwidth, INT32 operations / rate), in seconds."""
    p = PEAKS.get(card)
    if p is None:
        return None
    return max(nbytes / p["bytes_per_s"], nops / p["int32_ops_per_s"])
