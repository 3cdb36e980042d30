"""MHAP's option parser, flags and presets (the port's copy of
mhap_tpu/cli/main.py:22-183, 286-295; parity target
utils/ParseOptions.java and main/MhapMain.java:137-198).

The flag set is the JAX CLI's, so every command line it accepts parses
here too; cli/main.py stops on the flags the port does not run yet.
"""

from __future__ import annotations

import os

from ..utils import trace


class Option:
    def __init__(self, name, desc, default):
        self.name = name
        self.desc = desc
        self.default = default
        self.value = default
        self.is_set = False

    def set(self, value):
        t = type(self.default)
        if t is bool:
            self.value = True
        elif t is int:
            self.value = int(value)
        elif t is float:
            self.value = float(value)
        else:
            self.value = value
        self.is_set = True


class ParseOptions:
    """Typed flag parser (utils/ParseOptions.java)."""

    def __init__(self):
        self.options: dict[str, Option] = {}
        self.start_text: list[str] = []

    def add_start_text(self, line):
        self.start_text.append(line)

    def add(self, name, desc, default):
        self.options[name] = Option(name, desc, default)

    def get(self, name) -> Option:
        return self.options[name]

    def help_menu(self) -> str:
        out = list(self.start_text)
        for name in sorted(self.options):
            o = self.options[name]
            out.append(f"\t\t{name} = [{type(o.default).__name__}], "
                       f"default: {o.default}")
            out.append(f"\t\t\t{o.desc}")
        return "\n".join(out)

    def process(self, args) -> bool:
        i = 0
        while i < len(args):
            a = args[i]
            if a in ("-h", "--help"):
                print(self.help_menu())
                return False
            if a == "--version":
                print("2.1.3-tpu")
                return False
            if a not in self.options:
                # -sfile style concatenation for short flags
                matched = None
                for name in self.options:
                    if len(name) == 2 and a.startswith(name) and len(a) > 2:
                        matched = name
                        break
                if matched is None:
                    print(f"Unknown option {a}.")
                    print(self.help_menu())
                    return False
                self.options[matched].set(a[2:])
                i += 1
                continue
            o = self.options[a]
            if type(o.default) is bool:
                o.set(True)
                i += 1
            else:
                if i + 1 >= len(args):
                    print(f"Missing value for option {a}.")
                    return False
                o.set(args[i + 1])
                i += 2
        return True

    def __str__(self):
        return "\n".join(f"{name} = {self.options[name].value}"
                         for name in sorted(self.options))


PRESETS = {
    1: {"-k": 16, "--num-min-matches": 3, "--num-hashes": 512,
        "--threshold": 0.78, "--ordered-sketch-size": 1536,
        "--ordered-kmer-size": 12},
    2: {"-k": 16, "--num-min-matches": 3, "--num-hashes": 256,
        "--threshold": 0.80, "--ordered-sketch-size": 1000,
        "--ordered-kmer-size": 14},
    3: {"-k": 16, "--num-min-matches": 2, "--num-hashes": 768,
        "--threshold": 0.73, "--ordered-sketch-size": 1536,
        "--ordered-kmer-size": 12},
}


def build_options() -> ParseOptions:
    o = ParseOptions()
    o.add_start_text(
        "MHAP-TPU: TPU-native MinHash Alignment Protocol. A tool for "
        "finding overlaps of long-read sequences (such as PacBio or "
        "Nanopore) in bioinformatics.")
    o.add("-s", "Usage 1 only. The FASTA or binary dat file of reads stored"
          " in a box that all subsequent reads are compared to.", "")
    o.add("-q", "Usage 1: FASTA file/directory compared to the box (-s). "
          "Usage 2: output directory for binary dat files.", "")
    o.add("-p", "Usage 2 only. Directory of FASTA files to convert to "
          "binary format.", "")
    o.add("-f", "k-mer filter file (sorted by descending frequency).", "")
    o.add("-k", "[int], k-mer size used for MinHashing.", 16)
    o.add("--num-hashes", "[int], Number of min-mers for MinHashing.", 512)
    o.add("--threshold", "[double], Second-stage identity cutoff.", 0.78)
    o.add("--filter-threshold", "[double], filter-file repetitive cutoff.",
          1.0e-5)
    o.add("--max-shift", "[double], valid match region around the "
          "estimated overlap.", 0.2)
    o.add("--num-min-matches", "[int], min shared min-mers before stage "
          "2.", 3)
    o.add("--num-threads", "[int], host worker threads.",
          os.cpu_count() or 1)
    o.add("--repeat-weight", "[double] tf-idf repeat suppression "
          "strength.", 0.9)
    o.add("--repeat-idf-scale", "[double] upper idf scale bound.", 3.0)
    o.add("--ordered-kmer-size", "[int] second-stage k-mer size.", 12)
    o.add("--ordered-sketch-size", "[int] second-stage sketch size.", 1536)
    o.add("--min-store-length", "[int], min read length stored in box.", 0)
    o.add("--min-olap-length", "[int], min read length overlapped.", 116)
    o.add("--no-self", "Skip overlaps inside the box.", False)
    o.add("--store-full-id", "Store full FASTA ids (first token).", False)
    o.add("--supress-noise", "[int] 0) off 1) drop non-filter k-mers "
          "2) suppress non-filter k-mers.", 0)
    o.add("--no-tf", "Disable tf in tf-idf weighing.", False)
    o.add("--no-rc", "Do not use reverse complements.", False)
    o.add("--settings", "Presets for unset flags: 0) none 1) default "
          "2) fast 3) sensitive.", 0)
    o.add("--backend", "device (TPU pipeline), sharded (all visible "
          "devices, SPMD over a mesh) or oracle (numpy reference).",
          "device")
    o.add("--paf", "Emit PAF instead of MHAP M4 output.", False)
    return o


def options_to_cfg(o: ParseOptions) -> dict:
    return dict(
        kmer_size=o.get("-k").value,
        num_hashes=o.get("--num-hashes").value,
        num_min_matches=o.get("--num-min-matches").value,
        threshold=o.get("--threshold").value,
        ordered_kmer_size=o.get("--ordered-kmer-size").value,
        ordered_sketch_size=o.get("--ordered-sketch-size").value,
        max_shift=o.get("--max-shift").value,
        min_store_length=o.get("--min-store-length").value,
        min_olap_length=o.get("--min-olap-length").value,
        repeat_weight=o.get("--repeat-weight").value,
    )


def _load_reads(path: str, store_full_id: bool):
    """(headers or None, reads) of a FASTA/FASTQ file."""
    from ..io.fasta import read_sequences

    headers, reads = [], []
    with trace.span("load"):
        for h, s in read_sequences(path, store_full_id):
            headers.append(h)
            reads.append(s)
    return headers if store_full_id else None, reads
