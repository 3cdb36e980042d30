"""EstimateROC: sensitivity/specificity/PPV of an overlap set vs truth.

Behavioral mirror of main/EstimateROC.java: loads a BLASR M4 truth mapping
(best-score placement per read, identity/coverage filters,
processReference :548-627), the overlapper's output in any of the 4
supported formats (CA ovl 6/7-col, MHAP 12-col, BLASR M4 13-col,
DAligner bracketed; getOverlapInfo :375-476), and the read FASTA;
Monte-Carlo estimates with java.util.Random(0) parity, or the exhaustive
O(N^2) mode (fullEstimate :886-914).  Disputed PPV pairs are adjudicated
with the native Smith-Waterman library (utils/native.py), our rebuild of
the reference's libsswjni JNI component (:294-313, :789), pair by pair,
or all at once by kernel 5 (ops/swalign_kernels.py) on ``device``.

The port's copy of mhap_tpu/tools/estimate_roc.py: the same parsers,
Random(0) stream, estimators and float64 identity arithmetic; the
batched adjudication runs on the GPU unless the caller asks for the CPU
(``device="cpu"``, the plain version).
"""

from __future__ import annotations

import re
import sys
import time

import numpy as np
from dataclasses import dataclass, field

from ..device import resolve_device
from ..utils.intervals import IntervalIndex, range_overlap
from ..utils.javarandom import JavaRandom

MIN_REF_OVERLAP_DIFFERENCE = 0.8
REF_IDENTITY_ADJUSTMENT = 0.1
DEFAULT_NUM_TRIALS = 10000
DEFAULT_MIN_OVL = 2000


@dataclass
class Overlap:
    id1: str = None
    id2: str = None
    afirst: int = 0
    asecond: int = 0
    bfirst: int = 0
    bsecond: int = 0
    is_fwd: bool = True

    def get_size(self) -> int:
        first = float(max(self.asecond, self.afirst) - min(self.asecond, self.afirst))
        first += float(max(self.bsecond, self.bfirst) - min(self.bsecond, self.bfirst))
        import math

        return int(math.floor(first / 2 + 0.5))


def _strip_id(tok: str) -> str:
    if "/" in tok:
        tok = tok[:tok.index("/")]
    if "," in tok:
        tok = tok.split(",")[1]
    return tok


@dataclass
class EstimateROC:
    min_ovl_len: int = DEFAULT_MIN_OVL
    num_trials: int = DEFAULT_NUM_TRIALS
    do_dp: bool = False
    min_identity: float = 0.70
    min_overlap_difference: float = 0.30
    load_all: bool = False
    seed: int = 0
    debug: bool = False
    device: object = "cuda"

    tp: int = 0
    fn: int = 0
    tn: int = 0
    fp: int = 0
    ppv: float = 0.0

    clusters: dict = field(default_factory=dict)      # chr -> IntervalIndex
    seq_to_chr: dict = field(default_factory=dict)
    seq_to_score: dict = field(default_factory=dict)
    seq_to_position: dict = field(default_factory=dict)
    seq_to_name: dict = field(default_factory=dict)   # counter -> id
    seq_name_to_index: dict = field(default_factory=dict)
    ovl_names: dict = field(default_factory=dict)     # pairName -> length
    ovl_info: dict = field(default_factory=dict)
    ovl_to_name: dict = field(default_factory=dict)   # counter -> pairName
    data_seq: list = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.generator = JavaRandom(self.seed)
        self.min_ref_identity = self.min_identity + REF_IDENTITY_ADJUSTMENT
        self.min_alignment_identity = self.min_identity - REF_IDENTITY_ADJUSTMENT

    # ---------------- loading ----------------

    def process_reference(self, path: str) -> None:
        """BLASR M4 truth mapping -> best placement per read (:548-627)."""
        from ..io.fasta import open_text

        counter = 0
        with open_text(path) as f:
            for line in f:
                t = line.split()
                if not t:
                    continue
                sid = _strip_id(t[0])
                idy = float(t[3])
                start, end = int(t[5]), int(t[6])
                seq_is_fwd = int(t[4])
                if seq_is_fwd != 0:
                    raise SystemExit(
                        "Error: malformed line, first sequences should "
                        "always be in fwd orientation")
                start_in_ref, end_in_ref = int(t[9]), int(t[10])
                ref_len = int(t[11])
                is_rev = int(t[8])
                score = int(t[2])
                if is_rev == 1:
                    start_in_ref, end_in_ref = (ref_len - end_in_ref,
                                                ref_len - start_in_ref)
                if idy < self.min_ref_identity * 100:
                    continue
                diff = (end - start) / (end_in_ref - start_in_ref)
                if diff < MIN_REF_OVERLAP_DIFFERENCE:
                    continue
                chrom = t[1]
                if sid in self.seq_to_position:
                    if score < self.seq_to_score[sid]:
                        self.seq_to_position[sid] = (start_in_ref, end_in_ref)
                        self.seq_to_chr[sid] = chrom
                        self.seq_to_score[sid] = score
                else:
                    self.seq_to_position[sid] = (start_in_ref, end_in_ref)
                    self.seq_to_chr[sid] = chrom
                    self.seq_to_name[counter] = sid
                    self.seq_name_to_index[sid] = counter
                    self.seq_to_score[sid] = score
                    counter += 1
        for sid, (s, e) in self.seq_to_position.items():
            chrom = self.seq_to_chr[sid]
            self.clusters.setdefault(chrom, IntervalIndex()).add(
                s, e, self.seq_name_to_index[sid])
        if not self.seq_to_position:
            raise SystemExit("Error: No sequence matches to reference loaded!")

    def load_fasta(self, path: str) -> None:
        from ..io.fasta import read_sequences

        self.data_seq = [s for _, s in read_sequences(path)]

    def parse_overlap_line(self, line: str) -> Overlap:
        """4-format overlap parser (getOverlapInfo :375-476)."""
        o = Overlap()
        t = line.split()
        try:
            if len(t) in (6, 7):  # CA ovl format
                o.id1, o.id2 = t[0], t[1]
                aoffset, boffset = int(t[3]), int(t[4])
                o.is_fwd = t[2].upper() == "N"
                if self.data_seq is not None:
                    alen = len(self.data_seq[int(o.id1) - 1])
                    blen = len(self.data_seq[int(o.id2) - 1])
                    o.afirst = max(0, aoffset)
                    o.asecond = min(alen, alen + boffset)
                    o.bfirst = -1 * min(0, aoffset)
                    o.bsecond = min(blen, blen - boffset)
            elif len(t) == 12:  # MHAP format
                o.id1, o.id2 = t[0], t[1]
                o.is_fwd = int(t[8]) == 0
                if self.data_seq is not None:
                    alen = len(self.data_seq[int(o.id1) - 1])
                    blen = len(self.data_seq[int(o.id2) - 1])
                    o.afirst, o.asecond = int(t[5]), int(t[6])
                    o.bfirst, o.bsecond = int(t[9]), int(t[10])
                    o.asecond = min(o.asecond, alen)
                    o.bsecond = min(o.bsecond, blen)
            elif len(t) == 13 and "[" not in line:  # BLASR M4
                o.afirst, o.asecond = int(t[5]), int(t[6])
                o.bfirst, o.bsecond = int(t[9]), int(t[10])
                o.is_fwd = int(t[8]) == 0
                if not o.is_fwd:
                    o.bsecond = int(t[11]) - int(t[9])
                    o.bfirst = int(t[11]) - int(t[10])
                o.id1 = _strip_id(t[0])
                o.id2 = t[1].split(",")[1] if "," in t[1] else t[1]
                if self.data_seq is not None:
                    o.asecond = min(o.asecond, len(self.data_seq[int(o.id1) - 1]))
                    o.bsecond = min(o.bsecond, len(self.data_seq[int(o.id2) - 1]))
            elif 13 <= len(t) <= 18:  # DAligner bracketed
                o.id1 = t[0].replace(",", "")
                o.id2 = t[1].replace(",", "")
                o.is_fwd = t[2].lower() == "n"
                parts = line.split("[")
                a_info = parts[1][:parts[1].index("]")]
                b_info = parts[2][:parts[2].index("]")]
                a = [x.strip() for x in a_info.replace(",", "").split("..")]
                b = [x.strip() for x in b_info.replace(",", "").split("..")]
                o.afirst, o.asecond = int(a[0]), int(a[1])
                o.bfirst, o.bsecond = int(b[0]), int(b[1])
                if not o.is_fwd:
                    blen = len(self.data_seq[int(o.id2) - 1])
                    o.bsecond = blen - int(b[0])
                    o.bfirst = blen - int(b[1])
        except (ValueError, IndexError) as e:
            print(f"Warning: could not parse input line: {line.rstrip()} {e}",
                  file=sys.stderr)
        return o

    def process_overlaps(self, path: str) -> None:
        from ..io.fasta import open_text

        counter = 0
        with open_text(path) as f:
            for line in f:
                if not line.strip():
                    continue
                ovl = self.parse_overlap_line(line)
                if ovl.id1 is None or ovl.id2 is None:
                    continue
                if ovl.id1.lower() == ovl.id2.lower():
                    continue
                if not self.load_all and (
                        self.seq_to_chr.get(ovl.id1) is None
                        or self.seq_to_chr.get(ovl.id2) is None):
                    continue
                name = self._ovl_name(ovl.id1, ovl.id2)
                olen = ovl.get_size()
                if name in self.ovl_names and olen < self.ovl_names[name]:
                    continue
                if name in self.ovl_names:
                    self.ovl_names[name] = olen
                    self.ovl_info[name] = ovl
                else:
                    self.ovl_names[name] = olen
                    self.ovl_to_name[counter] = name
                    self.ovl_info[name] = ovl
                    counter += 1
        if not self.ovl_names:
            raise SystemExit("Error: No sequence matches to reference loaded!")

    # ---------------- internals ----------------

    @staticmethod
    def _ovl_name(id1: str, id2: str) -> str:
        return f"{id1}_{id2}" if id1 <= id2 else f"{id2}_{id1}"

    def _pick_random_sequence(self) -> str:
        return self.seq_to_name[self.generator.next_int(len(self.seq_to_name))]

    def _pick_random_match(self) -> str:
        return self.ovl_to_name[self.generator.next_int(len(self.ovl_to_name))]

    def _get_overlap_size(self, id1: str, id2: str) -> int:
        if self.seq_to_chr[id1].lower() != self.seq_to_chr[id2].lower():
            raise SystemExit(
                f"Error: comparing wrong chromosomes betweeen sequences "
                f"{id1} and sequence {id2}")
        p1 = self.seq_to_position[id1]
        p2 = self.seq_to_position[id2]
        return range_overlap(p1[0], p1[1], p2[0], p2[1])

    def _get_sequence_matches(self, sid: str, min_len: int):
        chrom = self.seq_to_chr.get(sid)
        p1 = self.seq_to_position.get(sid)
        if chrom is None or p1 is None:
            return None
        result = set()
        for idx in self.clusters[chrom].get(p1[0], p1[1]):
            id2 = self.seq_to_name[idx]
            p2 = self.seq_to_position[id2]
            overlap = range_overlap(p1[0], p1[1], p2[0], p2[1])
            if overlap >= min_len and sid.lower() != id2.lower():
                result.add(id2)
        return result

    def _overlap_exists(self, id1: str, id2: str) -> bool:
        return self._ovl_name(id1, id2) in self.ovl_names

    def _overlap_matches(self, id1: str, id2: str) -> bool:
        ref_overlap = self._get_overlap_size(id1, id2)
        ovl = self.ovl_info.get(self._ovl_name(id1, id2))
        if ovl is None:
            return False
        diff = abs(ovl.get_size() - ref_overlap)
        return diff / ref_overlap <= self.min_overlap_difference

    def _compute_dp(self, id1: str, id2: str) -> bool:
        """SW adjudication via the native library (computeDP :746-800)."""
        if not self.do_dp:
            return False
        from ..utils import native
        from ..utils.seq import reverse_complement

        ovl = self.ovl_info[self._ovl_name(id1, id2)]
        s1 = self.data_seq[int(ovl.id1) - 1][ovl.afirst:ovl.asecond]
        s2 = self.data_seq[int(ovl.id2) - 1][ovl.bfirst:ovl.bsecond]
        if not ovl.is_fwd:
            s2 = reverse_complement(s2)
        ovl_len = min(len(s1), len(s2))
        if not s1 or not s2:
            return False
        r = native.sw_align(s1.encode(), s2.encode(),
                            match=2, mismatch=-2, gap_open=2, gap_extend=1)
        length = max(r["q_end"] - r["q_begin"], r["r_end"] - r["r_begin"])
        score = r["identity"]
        return (score > self.min_alignment_identity
                and length > self.min_ovl_len
                and 1 - length / ovl_len < self.min_overlap_difference)

    # ---------------- estimators ----------------

    def _check_matches(self, sid: str, matches) -> None:
        for m in matches:
            if self._overlap_matches(sid, m):
                self.tp += 1
            else:
                self.fn += 1

    def estimate_sensitivity(self) -> None:
        for _ in range(self.num_trials):
            matches = None
            sid = None
            while not matches:
                sid = self._pick_random_sequence()
                matches = self._get_sequence_matches(sid, self.min_ovl_len)
            self._check_matches(sid, matches)

    def estimate_specificity(self) -> None:
        for _ in range(self.num_trials):
            sid = self._pick_random_sequence()
            other = self._pick_random_sequence()
            while sid.lower() == other.lower():
                other = self._pick_random_sequence()
            matches = self._get_sequence_matches(sid, 0)
            if self._overlap_exists(sid, other):
                if other not in matches:
                    self.fp += 1
            else:
                if other not in matches:
                    self.tn += 1

    def estimate_ppv(self, batch_dp: bool = False) -> None:
        """PPV sampling.  batch_dp=True defers disputed pairs and
        adjudicates them with the batched Smith-Waterman kernel on
        ``device`` (ops/swalign_kernels.py) instead of per-pair host calls
        -- the GPU form of the reference's parallel-stream JNI alignment
        (EstimateROC.java:746-800)."""
        num_tp = 0
        disputed: list[tuple[str, str]] = []
        for _ in range(self.num_trials):
            ovl_len = 0
            name = None
            while ovl_len < self.min_ovl_len:
                name = self._pick_random_match()
                o = self.ovl_info[name]
                ovl_len = range_overlap(o.afirst, o.asecond,
                                        o.bfirst, o.bsecond)
            id1, id2 = name.split("_")
            matches = self._get_sequence_matches(id1, 0)
            if matches is not None and id2 in matches:
                num_tp += 1
            elif self.do_dp and batch_dp:
                disputed.append((id1, id2))
            elif self._compute_dp(id1, id2):
                num_tp += 1
        if disputed:
            num_tp += int(np.sum(self._compute_dp_batch(disputed)))
        self.ppv = num_tp / self.num_trials

    def dp_batch_inputs(self, pairs: list):
        """The disputed pairs' overlap regions packed for sw_align_batch,
        on ``device``: q [P, n] and r [P, m] uint8 (zero padded), qlen
        and rlen [P] int32; and each pair's overlap length (numpy)."""
        import torch

        from ..ops.swalign import pack_pairs
        from ..utils.seq import reverse_complement

        seqs, ovl_lens = [], []
        for id1, id2 in pairs:
            ovl = self.ovl_info[self._ovl_name(id1, id2)]
            s1 = self.data_seq[int(ovl.id1) - 1][ovl.afirst:ovl.asecond]
            s2 = self.data_seq[int(ovl.id2) - 1][ovl.bfirst:ovl.bsecond]
            if not ovl.is_fwd:
                s2 = reverse_complement(s2)
            seqs.append((s1.encode(), s2.encode()))
            ovl_lens.append(min(len(s1), len(s2)))
        args = [torch.from_numpy(x).to(self.device)
                for x in pack_pairs(seqs)]
        return args, np.asarray(ovl_lens)

    def _compute_dp_batch(self, pairs: list) -> "np.ndarray":
        """Batched device SW adjudication of disputed pairs."""
        from ..ops.swalign_kernels import sw_align_batch

        args, ovl_lens = self.dp_batch_inputs(pairs)
        out = {k: v.cpu().numpy() for k, v in sw_align_batch(
            *args, match=2, mismatch=-2, gap_open=2, gap_extend=1).items()}
        length = np.maximum(out["q_end"] - out["q_begin"],
                            out["r_end"] - out["r_begin"])
        with np.errstate(divide="ignore", invalid="ignore"):
            score = 1.0 - out["errors"] / np.maximum(out["length"], 1)
        ovl_lens = np.maximum(ovl_lens, 1)
        return ((score > self.min_alignment_identity)
                & (length > self.min_ovl_len)
                & (1 - length / ovl_lens < self.min_overlap_difference))

    def full_estimate(self) -> None:
        """Exhaustive O(N^2) mode (fullEstimate :886-914)."""
        n = len(self.seq_to_name)
        for i in range(n):
            id1 = self.seq_to_name.get(i)
            for j in range(i + 1, n):
                id2 = self.seq_to_name.get(j)
                if id1 is None or id2 is None:
                    continue
                matches = self._get_sequence_matches(id1, 0)
                if not self._overlap_matches(id1, id2):
                    if id2 not in matches:
                        self.tn += 1
                    elif self._get_overlap_size(id1, id2) > self.min_ovl_len:
                        self.fn += 1
                else:
                    if id2 in matches:
                        self.tp += 1
                    elif self._compute_dp(id1, id2):
                        self.tp += 1
                    else:
                        self.fp += 1
        self.ppv = self.tp / (self.tp + self.fp) if self.tp + self.fp else 0.0

    # ---------------- results ----------------

    def sensitivity(self) -> float:
        return self.tp / (self.tp + self.fn) if self.tp + self.fn else 0.0

    def specificity(self) -> float:
        return self.tn / (self.fp + self.tn) if self.fp + self.tn else 0.0


def main(argv=None, device="cuda") -> int:
    """The tool's command line; the estimator is made on ``device`` (the
    GPU unless a caller, such as a test, asks for the CPU), though PPV
    adjudicates pair by pair with the native library, as the JAX tool
    does."""
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 3:
        print("This program uses random sampling to estimate "
              "PPV/Sensitivity/Specificity", file=sys.stderr)
        print("\t1. A blasr M4 file mapping sequences to a reference",
              file=sys.stderr)
        print("\t2. All-vs-all mappings of same sequences", file=sys.stderr)
        print("\t3. Fasta sequences numbered 1 to N", file=sys.stderr)
        print(f"\t4. Minimum overlap length (default: {DEFAULT_MIN_OVL})",
              file=sys.stderr)
        print(f"\t5. Number of random trials, 0 = full compute (default: "
              f"{DEFAULT_NUM_TRIALS})", file=sys.stderr)
        print("\t6. Compute DP during PPV true/false", file=sys.stderr)
        return 1
    g = EstimateROC(
        min_ovl_len=int(argv[3]) if len(argv) > 3 else DEFAULT_MIN_OVL,
        num_trials=int(argv[4]) if len(argv) > 4 else DEFAULT_NUM_TRIALS,
        do_dp=argv[5].lower() == "true" if len(argv) > 5 else False,
        debug=argv[6].lower() == "true" if len(argv) > 6 else False,
        min_identity=float(argv[7]) if len(argv) > 7 else 0.70,
        min_overlap_difference=float(argv[8]) if len(argv) > 8 else 0.30,
        load_all=argv[9].lower() == "true" if len(argv) > 9 else False,
        device=device,
    )
    t0 = time.time()
    print("Loading reference...", end="", file=sys.stderr)
    g.process_reference(argv[0])
    print(f"done {time.time() - t0}s.", file=sys.stderr)
    print("Loading fasta...", end="", file=sys.stderr)
    g.load_fasta(argv[2])
    print("Loading matches...", end="", file=sys.stderr)
    g.process_overlaps(argv[1])
    if g.num_trials == 0:
        g.full_estimate()
    else:
        g.estimate_sensitivity()
        g.estimate_specificity()
        g.estimate_ppv()
    print("Estimated sensitivity:\t%.4f" % g.sensitivity())
    print("Estimated specificity:\t%.4f" % g.specificity())
    print("Estimated PPV:\t %.4f" % g.ppv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
