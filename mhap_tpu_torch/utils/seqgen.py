"""Random DNA + sequencing-error simulation (the port's copy of
mhap_tpu/utils/seqgen.py).

Parity target: utils/RandomSequenceGenerator.java -- base draws from
MersenneTwisterFast quartiles, ``add_pacbio_error`` = ins 11.88% /
del 1.83% / sub 1.29% (:94-97), ``add_error`` single linked-list pass
where errorType thresholds use the RAW rates (:99-156; note the
difference from KmerStatSimulator, which normalizes to percentages).
"""

from __future__ import annotations

from .mersenne import MersenneTwisterFast


class RandomSequenceGenerator:
    def __init__(self, seed: int | None = None):
        self.rand = MersenneTwisterFast(seed if seed is not None else 4357)

    def _random_base(self, exclude: str | None) -> str:
        while True:
            b = self.rand.next_double()
            r = "A" if b < 0.25 else "C" if b < 0.5 else "G" if b < 0.75 else "T"
            if exclude is None or r != exclude:
                return r

    def generate_random_sequence(self, length: int) -> str:
        return "".join(self._random_base(None) for _ in range(length))

    def add_pacbio_error(self, s: str) -> str:
        return self.add_error(s, 0.1188, 0.0183, 0.0129)

    def add_error(self, s: str, insertion_rate: float, deletion_rate: float,
                  substitution_rate: float) -> str:
        if min(insertion_rate, deletion_rate, substitution_rate) < 0.0:
            raise ValueError("Error rate cannot be negative.")
        if insertion_rate + deletion_rate + substitution_rate > 1.00001:
            raise ValueError("Error rate must be less than or equal to 1.0.")
        error_rate = insertion_rate + deletion_rate + substitution_rate
        out: list[str] = []
        for ch in s:
            if self.rand.next_double() < error_rate:
                etype = self.rand.next_double()
                if etype < substitution_rate:
                    out.append(self._random_base(ch))
                elif etype < insertion_rate + substitution_rate:
                    out.append(self._random_base(None))
                    out.append(ch)
                else:
                    pass
            else:
                out.append(ch)
        return "".join(out)
