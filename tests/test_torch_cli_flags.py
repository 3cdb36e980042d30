"""The port's CLI against the JAX CLI on the flags no other test holds:
``--paf``, ``--no-rc``, ``--no-self``, ``--store-full-id``, the
``--settings`` 2 and 3 presets, FASTQ and gzipped input, and ``-q``
given a directory of two files (query ids carry on across the files).
Both CLIs run in process on the same files (``torch_cli_util``), at the
tiny widths of the other CLI tests; their stdout must be equal."""

import gzip

import pytest
import torch

from torch_cli_util import both

torch.set_num_threads(1)

CFG_FLAGS = ["--num-hashes", "128", "--ordered-sketch-size", "512",
             "--num-min-matches", "2"]


@pytest.fixture(scope="module")
def files(synthetic_reads, tmp_path_factory):
    """Eight box reads and four queries as FASTA (headers with a second
    field, as --store-full-id keeps only the first), FASTQ, gzipped
    FASTA, and a directory holding the queries as two files."""
    _genome, rs, _pos = synthetic_reads
    d = tmp_path_factory.mktemp("flags")
    box, queries = rs[:8], rs[8:12]
    fasta = "".join(f">read_{i} len={len(r)}\n{r}\n"
                    for i, r in enumerate(box))
    (d / "box.fa").write_text(fasta)
    with gzip.open(d / "box.fa.gz", "wt") as f:
        f.write(fasta)
    (d / "box.fq").write_text("".join(
        f"@read_{i}\n{r}\n+\n{'I' * len(r)}\n" for i, r in enumerate(box)))
    (d / "q.fa").write_text("".join(f">q_{i}\n{r}\n"
                                    for i, r in enumerate(queries)))
    (d / "qdir").mkdir()
    for j, part in enumerate((queries[:2], queries[2:])):
        (d / "qdir" / f"part{j}.fa").write_text("".join(
            f">q_{j}_{i}\n{r}\n" for i, r in enumerate(part)))
    return d


CASES = {
    "paf": lambda d: ["-s", d / "box.fa", "--paf"],
    "no-rc": lambda d: ["-s", d / "box.fa", "--no-rc"],
    "no-self": lambda d: ["-s", d / "box.fa", "-q", d / "q.fa",
                          "--no-self"],
    "store-full-id": lambda d: ["-s", d / "box.fa", "-q", d / "q.fa",
                                "--store-full-id"],
    "settings-2": lambda d: ["-s", d / "box.fa", "--settings", "2"],
    "settings-3": lambda d: ["-s", d / "box.fa", "--settings", "3"],
    "fastq": lambda d: ["-s", d / "box.fq"],
    "gzip": lambda d: ["-s", d / "box.fa.gz"],
    "query-dir": lambda d: ["-s", d / "box.fa", "-q", d / "qdir"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_flag_gives_jax_cli_stdout(files, tmp_path, capsys, case):
    argv = [str(a) for a in CASES[case](files)] + CFG_FLAGS
    want, got = both(lambda _d: argv, tmp_path, capsys)
    assert got == want and got
    if case == "query-dir":  # ids 9-12 run on across part0 and part1
        assert {int(line.split()[0]) for line in got} & {11, 12}
    if case == "store-full-id":
        assert all(line.split()[0].startswith(("read_", "q_"))
                   for line in got)
