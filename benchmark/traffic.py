"""The one generator of the benchmark's inputs, driven by a traffic file
(``traffic/<name>.json``) and a configuration file
(``configs/<name>.json``).

A traffic file gives the read set: how many reads, their length law,
coverage and error rate, an optional repeat family in the genome, an
optional k-mer filter file written from the genome, how many FASTA blocks
the reads are split into, and how many queries the check samples.  A
configuration gives MHAP's flags and the task that runs them:

* ``self``: each job is ``-s block0.fa`` (all against all);
* ``canu``: set-up runs ``-p`` on each block, as Canu does, and each job
  is ``-s block0.dat -q <dir of the other blocks' .dat files>``.

The same seed gives the same files.  The layout is the same for every
seed: the read lengths (the length law's quantiles), each read's start in
the genome and the repeat copies' positions come from one fixed
generator, and so does the split of the reads into blocks.  The seed
draws the genome's bases, the repeat's sequence, the reads' errors and
the order of the reads within each block, so that every seed asks the
same work of the program in another order and on other bases.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from . import generators as gen

FILTER_NAME = "kmers.txt"


def rng(seed: int, stream: int):
    """An independent generator for each use of the seed."""
    return np.random.default_rng([seed % (1 << 64), stream])


@dataclass
class Inputs:
    reads: list                # every read, in file order across blocks
    blocks: list               # (first, end) read index of each block
    bases: int                 # bases a job reads, as store or query
    job_argv: list
    setup_argvs: list = field(default_factory=list)
    filter_path: str | None = None
    sample_rng: object = None


LAYOUT_SEED = 0


def make_reads(traffic: dict, seed: int):
    """(reads, genome) of a traffic file's read set."""
    L = traffic["length"]
    n = traffic["reads"]
    layout = rng(LAYOUT_SEED, 0)
    lens = gen.quantile_lengths(n, L["median"], L["sigma"], L["min"],
                                L["max"], layout)
    glen = int(lens.sum() / traffic["coverage"])
    starts = layout.integers(0, glen, n)
    rep = traffic.get("repeat")
    rep_len = rep["length"] if rep else 2000
    copies = layout.integers(0, glen - rep_len, round(
        rep["share"] * glen / rep_len)) if rep else ()
    # the tail past genome_len holds the reads that start near its end
    genome = gen.repeat_seeded_genome(
        rng(seed, 2), glen, int(lens.max() * 1.15) + 12000, rep_len, copies)
    # each block holds the same reads for every seed, in the seed's order
    nb = traffic.get("blocks", 1)
    cut = [n * b // nb for b in range(nb + 1)]
    r = rng(seed, 1)
    order = np.concatenate([lo + r.permutation(hi - lo)
                            for lo, hi in zip(cut[:-1], cut[1:])])
    reads, _ = gen.placed_reads(rng(seed, 3), lens[order], starts[order],
                                genome, traffic["error"])
    return reads, genome


def flag_argv(flags: dict) -> list:
    out = []
    for name, value in flags.items():
        if value is True:
            out.append(name)
        elif value is not False:
            out += [name, str(value)]
    return out


def make_inputs(traffic: dict, config: dict, seed: int, workdir: str
                ) -> Inputs:
    """Writes the read set's files under workdir and returns the job."""
    reads, genome = make_reads(traffic, seed)
    nb = traffic.get("blocks", 1)
    cut = [len(reads) * b // nb for b in range(nb + 1)]
    blocks = list(zip(cut[:-1], cut[1:]))  # as make_reads cuts them
    fasta = os.path.join(workdir, "fasta")
    for b, (lo, hi) in enumerate(blocks):
        # a directory a block, so that -p sketches one block at a time
        os.makedirs(os.path.join(fasta, f"block{b}"))
        with open(os.path.join(fasta, f"block{b}", f"block{b}.fa"),
                  "w") as f:
            f.writelines(f">{i + 1}\n{reads[i]}\n" for i in range(lo, hi))
    flags = dict(config["flags"])
    filter_path = None
    if traffic.get("filter"):
        F = traffic["filter"]
        filter_path = os.path.join(workdir, FILTER_NAME)
        gen.write_filter_file(genome, F["k"], filter_path, F["cutoff"],
                              F["top"])
        flags["-f"] = filter_path
    argv = flag_argv(flags)
    task = config["task"]
    if task == "self":
        if nb != 1:
            raise ValueError("a self job reads one block")
        return Inputs(reads, blocks, sum(map(len, reads)),
                      argv + ["-s", os.path.join(fasta, "block0",
                                                 "block0.fa")],
                      filter_path=filter_path, sample_rng=rng(seed, 4))
    if task == "canu":
        if nb < 2:
            raise ValueError("a canu job needs a store block and queries")
        dats = os.path.join(workdir, "dat")
        queries = os.path.join(workdir, "queries")
        os.makedirs(dats)
        os.makedirs(queries)
        # block 0 is the store, sketched into dat/; the rest into the
        # query directory
        setup = [argv + ["-p", os.path.join(fasta, f"block{b}"),
                         "-q", dats if b == 0 else queries]
                 for b in range(nb)]
        job = argv + ["-s", os.path.join(dats, "block0.dat"), "-q", queries]
        return Inputs(reads, blocks, sum(map(len, reads)), job, setup,
                      filter_path, rng(seed, 4))
    raise ValueError(f"unknown task {task!r}")

