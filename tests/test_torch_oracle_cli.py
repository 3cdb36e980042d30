"""``--backend oracle`` of the port's CLI against the JAX CLI's, both in
process on the same files (``torch_cli_util``): the same stdout and the
same closing ``Total matches found: N`` line for a self run at default
settings, ``-q`` over a directory, ``-f``, ``--no-self``, ``--paf`` and
``--store-full-id``; the same refusals of ``.dat`` input and ``-p`` (a
``.dat`` among the ``-q`` files the port refuses too, where the JAX CLI
reads it as FASTA).  The oracle backend runs on the host: the port's CLI
gets no device for it.  The bloom filter of --supress-noise 1 and 2
costs the oracle a murmur3 call a k-mer, so its methods are held
against JAX's in tests/test_torch_oracle.py instead."""

import numpy as np
import pytest
import torch

from mhap_tpu_torch.cli.main import main as port_main
from mhap_tpu_torch.ops.minhash_kernels import min_reduce_w1
from torch_cli_util import jax_cli_main, port_cli_main, run

torch.set_num_threads(1)

SMALL = ["--num-hashes", "128", "--ordered-sketch-size", "512",
         "--num-min-matches", "2"]


@pytest.fixture(scope="module")
def files(synthetic_reads, tmp_path_factory):
    """reads.fa (14 reads, the last with N bases), box.fa (the first 8),
    q/ with two query files of 3 reads, kmers.txt (a filter file)."""
    _genome, rs, _pos = synthetic_reads
    reads = list(rs[:14])
    reads[13] = reads[13][:800] + "NNNN" + reads[13][800:]
    d = tmp_path_factory.mktemp("oracle_cli")

    def fasta(path, rows, first=0):
        path.write_text("".join(f">read{first + i} x\n{r}\n"
                                for i, r in enumerate(rows)))
        return str(path)

    (d / "q").mkdir()
    fasta(d / "q" / "a.fa", reads[8:11], 8)
    fasta(d / "q" / "b.fa", reads[11:14], 11)
    rng = np.random.default_rng(4)
    lines = ["200 40"]
    for i in range(40):
        r = reads[i % 5]
        p = int(rng.integers(0, len(r) - 16))
        lines.append(f"{r[p:p + 16]} {float(rng.choice([2e-6, 1e-4, 2e-3]))}")
    (d / "kmers.txt").write_text("\n".join(lines) + "\n")
    return dict(reads=fasta(d / "reads.fa", reads),
                box=fasta(d / "box.fa", reads[:8]), q=str(d / "q"),
                kmers=str(d / "kmers.txt"), dir=d)


def both(argv, capsys):
    """(stdout lines, Total matches line) of the JAX CLI and the port's."""
    out = []
    for cli in (jax_cli_main, port_cli_main):
        lines, err = run(cli, [*argv, "--backend", "oracle"], capsys,
                         err=True)
        total = [l for l in err.splitlines()
                 if l.startswith("Total matches found:")]
        assert len(total) == 1, err[-2000:]
        out.append((lines, total[0]))
    return out


@pytest.mark.parametrize("case", ["self", "query_dir", "filter", "no_self",
                                  "paf_full_id"])
def test_oracle_cli_equals_jax(files, case, capsys):
    argv = {
        "self": ["-s", files["reads"]],
        "query_dir": ["-s", files["box"], "-q", files["q"], *SMALL],
        "filter": ["-s", files["reads"], "-f", files["kmers"], *SMALL],
        "no_self": ["-s", files["box"], "-q", files["q"], "--no-self",
                    *SMALL],
        "paf_full_id": ["-s", files["box"], "-q", files["q"], "--paf",
                        "--store-full-id", *SMALL],
    }[case]
    before = min_reduce_w1.launches
    (jl, jt), (pl, pt) = both(argv, capsys)
    assert pl == jl and pt == jt
    assert pt == f"Total matches found: {len(pl)}" and len(pl) >= 3
    assert min_reduce_w1.launches == before
    if case == "paf_full_id":
        assert all(l.split("\t")[0].startswith("read") for l in pl)


def test_oracle_cli_runs_without_a_device(files, capsys):
    """No device argument reaches the oracle: the default "cuda" runs it
    on a machine without a GPU too."""
    assert port_main(["-s", files["box"], *SMALL, "--backend",
                      "oracle"]) == 0
    assert capsys.readouterr().out


def test_oracle_cli_refusals(files, capsys):
    d = files["dir"]
    dats = d / "dats"
    dats.mkdir()
    assert port_cli_main(["-p", files["box"], "-q", str(dats), *SMALL]) == 0
    dat = str(dats / "box.dat")
    capsys.readouterr()
    both_clis = (jax_cli_main, port_cli_main)
    for argv, msg, clis in (
            (["-s", dat, *SMALL], ".dat input requires the device backend",
             both_clis),
            (["-s", files["box"], "-q", str(dats), *SMALL],
             ".dat input requires the device backend", (port_cli_main,)),
            (["-p", files["box"], "-q", str(d / "q")],
             "-p requires the device backend", both_clis)):
        for cli in clis:
            with pytest.raises(SystemExit, match=msg):
                cli([*argv, "--backend", "oracle"])
    assert not (d / "q" / "box.dat").exists()
    with pytest.raises(SystemExit, match="unknown --backend"):
        port_cli_main(["-s", files["box"], "--backend", "tpu"])
