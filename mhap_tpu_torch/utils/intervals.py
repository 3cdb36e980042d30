"""Interval index for truth-placement clustering (the port's copy of
mhap_tpu/utils/intervals.py).

Behavioral mirror of utils/IntervalTree.java as EstimateROC uses it:
interval queries use STRICT exclusive intersection, ``other.end > start
&& other.start < end`` (Interval.java:57-59).  A query is a boolean mask
over numpy (start, end) columns.
"""

from __future__ import annotations

import numpy as np


class IntervalIndex:
    def __init__(self):
        self._starts: list[int] = []
        self._ends: list[int] = []
        self._data: list = []
        self._arr = None

    def add(self, start: int, end: int, data) -> None:
        self._starts.append(start)
        self._ends.append(end)
        self._data.append(data)
        self._arr = None

    def _build(self):
        if self._arr is None:
            self._arr = (np.asarray(self._starts, np.int64),
                         np.asarray(self._ends, np.int64))
        return self._arr

    def get(self, start: int, end: int) -> list:
        """All data whose interval strictly intersects [start, end]
        (Interval.intersects: end > s and start < e)."""
        if not self._data:
            return []
        s, e = self._build()
        mask = (end > s) & (start < e)
        return [self._data[i] for i in np.nonzero(mask)[0]]

    def stab(self, time: int) -> list:
        """Data whose interval strictly contains time (Interval.contains)."""
        if not self._data:
            return []
        s, e = self._build()
        mask = (time > s) & (time < e)
        return [self._data[i] for i in np.nonzero(mask)[0]]

    def __len__(self):
        return len(self._data)


def range_overlap(start_a: int, end_a: int, start_b: int, end_b: int) -> int:
    """Utils.getRangeOverlap: inclusive overlap length (can be <= 0)."""
    min_a, max_a = min(start_a, end_a), max(start_a, end_a)
    min_b, max_b = min(start_b, end_b), max(start_b, end_b)
    return min(max_a, max_b) - max(min_a, min_b) + 1
