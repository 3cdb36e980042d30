"""GetHistogramStats: k-mer histogram -> mean/stdev/cutoffs (the port's
copy of mhap_tpu/tools/get_histogram_stats.py).

Behavioral mirror of main/GetHistogramStats.java (:37-103): streaming
(Welford) mean/variance over the expanded histogram, the cumulative-
weighted-percent cutoff, and mean + 7*stdev.  Used to derive the
``--filter-threshold`` for tf-idf runs.
"""

from __future__ import annotations

import sys

NUM_SD = 7


class GetHistogramStats:
    def __init__(self, path: str, percent: float = 0.99):
        from ..io.fasta import open_text

        self.histogram: dict[int, int] = {}
        with open_text(path) as f:
            for line in f:
                t = line.split()
                if t:
                    self.histogram[int(t[0])] = int(t[1])
        self.percent = percent
        self.mean = 0.0
        self.stdev = 0.0
        self.cut = 0

    def process(self) -> None:
        variance = 0.0
        total = 0
        s = 0.0
        mean = 0.0
        for val in sorted(self.histogram):
            count = self.histogram[val]
            for _ in range(count):
                total += 1
                delta = val - mean
                mean += delta / total
                variance += delta * (val - mean)
                s += val
        self.mean = mean
        self.stdev = (variance / total) ** 0.5 if total else 0.0
        running = 0.0
        for val in sorted(self.histogram):
            running += float(val) * self.histogram[val]
            if running / s > self.percent:
                self.cut = val
                break

    def __str__(self):
        return "%.4f\t%.4f\t\t%d\t%.4f" % (
            self.mean, self.stdev, self.cut, self.mean + NUM_SD * self.stdev)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    s = GetHistogramStats(argv[0], float(argv[1]))
    s.process()
    print(s)
    return 0


if __name__ == "__main__":
    sys.exit(main())
