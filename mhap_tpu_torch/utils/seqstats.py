"""Sequence/statistics helpers from the reference's Utils grab-bag (the
port's copy of mhap_tpu/utils/seqstats.py).

Parity targets (utils/Utils.java): toProtein codon translation with 'X'
stops (:53-82, :533-551), FASTA 60/80-column reformatting
(convertToFasta :144-180), mean/std/pearson/linearRegression
(:382-441), range helpers (getRangeOverlap lives in utils/intervals.py).
"""

from __future__ import annotations

import numpy as np

from .seq import reverse_complement

_CODONS = {
    "AAA": "K", "AAC": "N", "AAG": "K", "AAT": "N", "ACA": "T", "ACC": "T",
    "ACG": "T", "ACT": "T", "AGA": "R", "AGC": "S", "AGG": "R", "AGT": "S",
    "ATA": "I", "ATC": "I", "ATG": "M", "ATT": "I", "CAA": "Q", "CAC": "H",
    "CAG": "Q", "CAT": "H", "CCA": "P", "CCC": "P", "CCG": "P", "CCT": "P",
    "CGA": "R", "CGC": "R", "CGG": "R", "CGT": "R", "CTA": "L", "CTC": "L",
    "CTG": "L", "CTT": "L", "GAA": "E", "GAC": "D", "GAG": "E", "GAT": "D",
    "GCA": "A", "GCC": "A", "GCG": "A", "GCT": "A", "GGA": "G", "GGC": "G",
    "GGG": "G", "GGT": "G", "GTA": "V", "GTC": "V", "GTG": "V", "GTT": "V",
    "TAA": "X", "TAC": "Y", "TAG": "X", "TAT": "Y", "TCA": "S", "TCC": "S",
    "TCG": "S", "TCT": "S", "TGA": "X", "TGC": "C", "TGG": "W", "TGT": "C",
    "TTA": "L", "TTC": "F", "TTG": "L", "TTT": "F",
}


def to_protein(genome: str, is_reversed: bool = False, frame: int = 0) -> str:
    """Utils.toProtein: codon translation, stops as 'X'; note the
    reference's loop bound stops 3 bases short of the end (i < len-3)."""
    if is_reversed:
        genome = reverse_complement(genome)
    genome = genome.replace("-", "")
    out = []
    i = frame
    while i < len(genome) - 3:
        out.append(_CODONS[genome[i:i + 3]])
        i += 3
    return "".join(out)


def convert_to_fasta(seq: str, width: int = 80) -> str:
    """Utils.convertToFasta-style fixed-width reflow."""
    return "\n".join(seq[i:i + width] for i in range(0, len(seq), width))


def mean(a) -> float:
    return float(np.mean(np.asarray(a, dtype=np.float64)))


def std(a) -> float:
    """Population standard deviation (Utils.std divides by N)."""
    return float(np.std(np.asarray(a, dtype=np.float64)))


def pearson_corr(a, b) -> float:
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if len(a) < 2:
        return 0.0
    return float(np.corrcoef(a, b)[0, 1])


def linear_regression(a, b) -> tuple[float, float]:
    """(alpha, beta) of the least-squares fit b ~ alpha + beta*a
    (Utils.linearRegression)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n_inv = 1.0 / len(a)
    beta = ((a * b).sum() - n_inv * a.sum() * b.sum()) / \
        ((a * a).sum() - n_inv * a.sum() ** 2)
    alpha = n_inv * (b.sum() - beta * a.sum())
    return alpha, beta
