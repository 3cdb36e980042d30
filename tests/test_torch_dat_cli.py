"""The port's CLI on ``.dat`` sketch files against the JAX CLI: ``-p``
then ``-s box.dat``, ``-q`` given a ``.dat`` file, and the Canu path with
``-f --supress-noise 1/2``, each with the same ``.dat`` bytes and the
same stdout as the JAX CLI (both in process, through ``torch_cli_util``),
and ``-p``'s missing target directory."""

import pytest
import torch

from test_filter import make_filter_file
from torch_cli_util import both, jax_cli_main, port_cli_main, run

torch.set_num_threads(1)

CFG_FLAGS = ["--num-hashes", "128", "--ordered-sketch-size", "512",
             "--num-min-matches", "2"]


def write_fasta(path, reads, first=0):
    path.write_text("".join(f">read{first + i + 1}\n{r}\n"
                            for i, r in enumerate(reads)))


@pytest.fixture(scope="module")
def reads(synthetic_reads):
    _genome, rs, _pos = synthetic_reads
    rs = list(rs[:12])
    rs[4] = rs[4][:200]  # 185 ordered k-mers: short of every sketch size
    return rs


def test_cli_dat_roundtrip(reads, tmp_path, capsys):
    """-p then -s box.dat resumes from the sketches: the same .dat bytes
    and the same lines as the JAX CLI."""
    fa_dir = tmp_path / "fastas"
    fa_dir.mkdir()
    write_fasta(fa_dir / "reads.fa", reads[:8])

    def argv_p(d):
        (d / "dats").mkdir()
        return ["-p", str(fa_dir), "-q", str(d / "dats")] + CFG_FLAGS

    both(argv_p, tmp_path, capsys)
    dat = (tmp_path / "port" / "dats" / "reads.dat").read_bytes()
    assert dat == (tmp_path / "jax" / "dats" / "reads.dat").read_bytes()
    want, got = both(lambda d: ["-s", str(d / "dats" / "reads.dat")]
                     + CFG_FLAGS, tmp_path, capsys)
    assert got == want and got


def test_cli_dat_query_file(reads, tmp_path, capsys):
    """-q given a .dat file: its queries print their -p-time ids."""
    fa_dir = tmp_path / "qf"
    fa_dir.mkdir()
    write_fasta(tmp_path / "box.fa", reads[:8])
    write_fasta(fa_dir / "queries.fa", reads[8:12])

    def argv_of(d):
        (d / "qd").mkdir()
        cli = port_cli_main if d.name == "port" else jax_cli_main
        assert run(cli, ["-p", str(fa_dir), "-q", str(d / "qd")]
                   + CFG_FLAGS, capsys) == []
        return ["-s", str(tmp_path / "box.fa"), "-q",
                str(d / "qd" / "queries.dat")] + CFG_FLAGS

    want, got = both(argv_of, tmp_path, capsys)
    assert got == want and got
    # box ids are 1-8; offset query ids would be 9-12
    assert max(int(line.split()[0]) for line in got) <= 8


@pytest.mark.parametrize("ru", [1, 2])
def test_cli_canu_path(reads, tmp_path, capsys, ru):
    """Canu's MHAP stage at tiny widths: -p over a directory of two
    blocks with -f and --supress-noise (the bloom, as both CLIs build
    it), then -s block0.dat -q <dir holding block1.dat>.  Same .dat bytes
    and the same stdout as the JAX CLI."""
    blocks = tmp_path / "blocks"
    blocks.mkdir()
    write_fasta(blocks / "block0.fa", reads[:6])
    write_fasta(blocks / "block1.fa", reads[6:], first=6)
    kf = tmp_path / "kmers.txt"
    kf.write_text("\n".join(make_filter_file(reads)) + "\n")
    flags = CFG_FLAGS + ["-f", str(kf), "--supress-noise", str(ru),
                         "--repeat-weight", "0.9", "--repeat-idf-scale",
                         "10"]

    def argv_p(d):
        (d / "dats").mkdir()
        return ["-p", str(blocks), "-q", str(d / "dats")] + flags

    both(argv_p, tmp_path, capsys)
    for b in ("block0.dat", "block1.dat"):
        assert ((tmp_path / "port" / "dats" / b).read_bytes()
                == (tmp_path / "jax" / "dats" / b).read_bytes())

    def argv_q(d):
        (d / "querydir").mkdir()
        (d / "querydir" / "block1.dat").write_bytes(
            (d / "dats" / "block1.dat").read_bytes())
        return ["-s", str(d / "dats" / "block0.dat"), "-q",
                str(d / "querydir")] + flags

    want, got = both(argv_q, tmp_path, capsys)
    assert got == want and len(got) > 3


def test_precompute_needs_target_dir(tmp_path):
    fa = tmp_path / "r.fa"
    write_fasta(fa, ["ACGT" * 100])
    argv = ["-p", str(fa), "-q", str(fa)]
    for cli in (jax_cli_main, port_cli_main):
        with pytest.raises(SystemExit, match="Target directory doesn't exit"):
            cli(argv)
