"""KmerStatSimulator: read simulation + sketch-estimator statistics (the
port's copy of mhap_tpu/tools/kmer_stat_simulator.py).

Behavioral mirror of main/KmerStatSimulator.java: two usage modes ---
(1) full args: per-trial overlapping + random pair comparison, reporting
shared-mer counts, exact k-mer Jaccard, bottom-k MinHash Jaccard
(canonical k-mers, sketch 1256), mash identity, and summary mean/stdev
rows; (2) short args (kmer < 0): simulate error-laden reads to FASTA.
Error model: per-base error with ins/del/sub split proportional to the
requested rates, applied over a linked-list pass (getSequence :233-303);
java.util.Random(seed=0) parity for the trial sequence.
"""

from __future__ import annotations

import sys

import numpy as np

from ..oracle import scorer as oscorer
from ..oracle import sketch as osketch
from ..utils.javarandom import JavaRandom

BASES = "ACGT"


class KmerStatSimulator:
    def __init__(self, total_trials: int, kmer: int = -1,
                 requested_length: float = 5000, overlap: int = 100,
                 reference: str | None = None, half_error: bool = False,
                 seed: int = 0):
        self.total_trials = total_trials
        self.kmer = kmer
        self.requested_length = requested_length
        self.overlap = overlap
        self.reference = reference
        self.half_error = half_error
        self.generator = JavaRandom(seed)
        self.skip_mers: set[str] = set()
        self.shared_count = 0
        self.shared_jaccard: list[float] = []
        self.shared_minhash: list[float] = []
        self.shared_mer_counts: list[float] = []
        self.random_jaccard: list[float] = []
        self.random_minhash: list[float] = []
        self.random_mer_counts: list[float] = []

    def load_skip_mers(self, path: str) -> None:
        from ..io.fasta import open_text

        with open_text(path) as f:
            for line in f:
                t = line.split()
                if t:
                    self.skip_mers.add(t[0])

    def _random_base(self, exclude: str | None) -> str:
        while True:
            b = self.generator.next_double()
            r = "A" if b < 0.25 else "C" if b < 0.5 else "G" if b < 0.75 else "T"
            if exclude is None or r != exclude:
                return r

    def build_random_sequence(self, length: int) -> str:
        return "".join(self._random_base(None) for _ in range(length))

    def get_sequence(self, seq_length: int, first_pos: int, sequence: str,
                     error_rate: float, insertion_rate: float,
                     deletion_rate: float, substitution_rate: float,
                     trim_right: bool) -> str:
        """Mutated window of 2*seq_length starting at first_pos (wrapping),
        trimmed to seq_length (getSequence :233-303)."""
        first = sequence[first_pos:min(len(sequence), first_pos + 2 * seq_length)]
        if len(first) < 2 * seq_length:
            first += sequence[:min(len(sequence), 2 * seq_length - len(first))]
        out: list[str] = []
        for ch in first:
            if self.generator.next_double() < error_rate:
                etype = self.generator.next_double()
                if etype < substitution_rate:
                    out.append(self._random_base(ch))
                elif etype < insertion_rate + substitution_rate:
                    # ListIterator.add inserts BEFORE the just-returned char
                    out.append(self._random_base(None))
                    out.append(ch)
                else:
                    pass  # delete
            else:
                out.append(ch)
        s = "".join(out)
        if trim_right:
            return s[:seq_length]
        return s[len(s) - seq_length:]

    def compare_kmers(self, first: str, second: str) -> float:
        """Exact k-mer Jaccard + shared count (compareKmers :164-187)."""
        k = self.kmer
        first_seqs = set()
        total = set()
        for i in range(len(first) - k + 1):
            mer = first[i:i + k]
            if mer not in self.skip_mers:
                first_seqs.add(mer)
            total.add(mer)
        shared = set()
        for i in range(len(second) - k + 1):
            mer = second[i:i + k]
            if mer in first_seqs:
                shared.add(mer)
            else:
                total.add(mer)
        self.shared_count = len(shared)
        return len(shared) / len(total)

    def compare_minhash(self, first: str, second: str) -> float:
        h1 = osketch.bottom_sketch_values(first, self.kmer, 1256, True)
        h2 = osketch.bottom_sketch_values(second, self.kmer, 1256, True)
        return osketch.bottom_values_jaccard(h1, h2)

    def simulate(self, insertion_rate: float, del_rate: float,
                 sub_rate: float, out=None) -> None:
        out = sys.stdout if out is None else out  # read at call time
        error_rate = insertion_rate + del_rate + sub_rate
        if error_rate < 0 or error_rate > 1:
            raise SystemExit("Error rate must be between 0 and 1")
        ins_p = insertion_rate / error_rate if error_rate else 0.0
        del_p = del_rate / error_rate if error_rate else 0.0
        sub_p = sub_rate / error_rate if error_rate else 0.0

        sequences = None
        if self.reference is not None:
            from ..io.fasta import read_sequences

            sequences = [s.upper().replace("N", "")
                         for _, s in read_sequences(self.reference)]

        L = int(self.requested_length)
        he = self.half_error
        for i in range(self.total_trials):
            first_pos = 0
            seq_id = 0
            if sequences is not None:
                sequence = None
                while sequence is None or len(sequence) < 4 * L:
                    seq_id = self.generator.next_int(len(sequences))
                    sequence = sequences[seq_id]
                first_pos = self.generator.next_int(len(sequence))
            else:
                sequence = self.build_random_sequence(L * 4)

            first_seq = self.get_sequence(L, first_pos, sequence, error_rate,
                                          ins_p, del_p, sub_p, False)
            if self.kmer < 0:
                out.write(f">s{i} {seq_id} {first_pos + L}\n")
                for j in range(0, len(first_seq), 80):
                    out.write(first_seq[j:j + 80] + "\n")
                continue

            offset = int(self.requested_length * 2 - self.overlap)
            second_pos = (first_pos + offset) % len(sequence)
            second_seq = self.get_sequence(
                L, second_pos, sequence, 0 if he else error_rate,
                0 if he else ins_p, 0 if he else del_p, 0 if he else sub_p,
                True)
            self.shared_jaccard.append(self.compare_kmers(first_seq, second_seq))
            self.shared_minhash.append(self.compare_minhash(first_seq, second_seq))
            self.shared_mer_counts.append(float(self.shared_count))

            if sequences is not None:
                from ..utils.intervals import range_overlap

                sequence = None
                second_id = 0
                while sequence is None or len(sequence) < 2 * L:
                    second_id = self.generator.next_int(len(sequences))
                    sequence = sequences[second_id]
                second_pos = self.generator.next_int(len(sequence))
                while (seq_id == second_id and range_overlap(
                        first_pos, first_pos + L,
                        second_pos, second_pos + L) > 0):
                    second_pos = self.generator.next_int(len(sequence))
                second_seq = self.get_sequence(
                    L, second_pos, sequence, 0 if he else error_rate,
                    0 if he else ins_p, 0 if he else del_p,
                    0 if he else sub_p, True)
            else:
                second_seq = self.build_random_sequence(L)

            self.random_jaccard.append(self.compare_kmers(first_seq, second_seq))
            self.random_minhash.append(self.compare_minhash(first_seq, second_seq))
            self.random_mer_counts.append(float(self.shared_count))

        if self.kmer < 0 or not self.shared_mer_counts:
            return
        for i in range(self.total_trials):
            out.write("%s\t%s\t%s\t%s\t%s\t%s\t%s\n" % (
                self.shared_mer_counts[i], self.shared_jaccard[i],
                self.shared_minhash[i],
                oscorer.jaccard_to_identity(self.shared_minhash[i], self.kmer),
                self.random_mer_counts[i], self.random_jaccard[i],
                self.random_minhash[i]))
        for label, vals in [
                ("Shared mer counts", self.shared_mer_counts),
                ("Shared jaccard", self.shared_jaccard),
                ("Shared MinHash jaccard", self.shared_minhash),
                ("Random mer counts", self.random_mer_counts),
                ("Random jaccard", self.random_jaccard),
                ("Random MinHash jaccard", self.random_minhash)]:
            a = np.asarray(vals)
            mean = a.mean()
            stdev = a.std(ddof=1) if len(a) > 1 else 0.0
            out.write(f"{label} stats: {mean}\t{stdev}\n")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) in (5, 6):
        sim = KmerStatSimulator(int(argv[0]),
                                requested_length=float(argv[1]),
                                reference=argv[5] if len(argv) > 5 else None)
        sim.simulate(float(argv[2]), float(argv[3]), float(argv[4]))
    elif len(argv) >= 7:
        sim = KmerStatSimulator(
            int(argv[0]), kmer=int(argv[1]), requested_length=float(argv[2]),
            overlap=int(argv[3]),
            half_error=argv[7].lower() == "true" if len(argv) > 7 else False,
            reference=argv[8] if len(argv) > 8 else None)
        if sim.overlap > sim.requested_length:
            raise SystemExit("Cannot have overlap > sequence length")
        if len(argv) > 9:
            sim.load_skip_mers(argv[9])
        sim.simulate(float(argv[4]), float(argv[5]), float(argv[6]))
    else:
        print("Example usage: simulateSharedKmers <#trials> <kmer size> "
              "<seq length> <overlap length> <insertion> <del> <subst> "
              "[only one sequence error] [reference genome] "
              "[kmers to ignore]", file=sys.stderr)
        print("Usage 2: simulateSharedKmers <#trials> <seq length> "
              "<insertion> <del> <subst> [reference genome]",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
