"""The port's CLI at ``--backend sharded`` on the CPU (gloo ranks): at
world size 1 in process, the lines of the device backend and of the JAX
CLI; at 2 ranks (``parallel/jobs.run_cli`` through
``parallel/launch.run_ranks``), ``-s block.dat -q dir`` prints the device
backend's lines, ``-p`` writes ``.dat`` files byte-equal to its, and so
do ``--store-full-id`` (headers gathered to every rank) and ``-f
--supress-noise 2``; rank 1 prints nothing.  Without a GPU the CLI's
sharded backend raises rather than run on the CPU."""

import contextlib
import io

import pytest
import torch

from mhap_tpu_torch.cli.main import main, sharded_comm
from mhap_tpu_torch.parallel import launch
from mhap_tpu_torch.parallel.jobs import run_cli
from test_filter import make_filter_file
from torch_cli_util import both, port_cli_main, run

torch.set_num_threads(1)

CFG_FLAGS = ["--num-hashes", "128", "--ordered-sketch-size", "512",
             "--num-min-matches", "2"]
SHARDED = ["--backend", "sharded"]


def write_fasta(path, reads, first=0):
    path.write_text("".join(f">read{first + i + 1} x\n{r}\n"
                            for i, r in enumerate(reads)))


@pytest.fixture(scope="module")
def reads(synthetic_reads):
    return list(synthetic_reads[1][:16])


def test_cli_sharded_world_one(reads, tmp_path, capsys):
    """One rank, in process: the JAX CLI's lines, and the device
    backend's stdout."""
    write_fasta(tmp_path / "reads.fa", reads[:12])
    argv = ["-s", str(tmp_path / "reads.fa")] + CFG_FLAGS
    want, device = both(lambda d: argv, tmp_path, capsys)
    got = run(port_cli_main, argv + SHARDED, capsys)
    assert got == device == want and got


@pytest.fixture(scope="module")
def two_ranks(reads, tmp_path_factory):
    """Each case's (device backend's stdout, the 2 ranks' stdouts) and
    the .dat bytes -p wrote with each backend."""
    d = tmp_path_factory.mktemp("sharded_cli")
    blocks, qdir = d / "blocks", d / "querydir"
    blocks.mkdir()
    qdir.mkdir()
    write_fasta(blocks / "block0.fa", reads[:10])
    write_fasta(blocks / "block1.fa", reads[10:16], first=10)
    (d / "kmers.txt").write_text("\n".join(make_filter_file(reads)) + "\n")
    for name in ("dev", "sharded"):
        (d / name).mkdir()
    fa = str(blocks / "block0.fa")
    cases = {
        "-p": ["-p", str(blocks), "-q", str(d / "{}")],
        "-s block.dat -q dir": ["-s", str(d / "dev" / "block0.dat"), "-q",
                                str(qdir)],
        "--store-full-id": ["-s", fa, "-q", str(blocks / "block1.fa"),
                            "--store-full-id"],
        "-f --supress-noise 2": ["-s", fa, "-f", str(d / "kmers.txt"),
                                 "--supress-noise", "2"],
    }
    device = {}
    for name, argv in cases.items():
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            assert port_cli_main([a.format("dev") for a in argv]
                                 + CFG_FLAGS) == 0
        device[name] = out.getvalue()
        if name == "-p":
            (qdir / "block1.dat").write_bytes(
                (d / "dev" / "block1.dat").read_bytes())
    argvs = [[a.format("sharded") for a in argv] + CFG_FLAGS + SHARDED
             for argv in cases.values()]
    ranks = launch.run_ranks(run_cli, 2, backend="gloo", devices=["cpu"] * 2,
                             args=(argvs,))
    return d, {name: (device[name], [r[j] for r in ranks])
               for j, name in enumerate(cases)}


@pytest.mark.parametrize("case", ["-p", "-s block.dat -q dir",
                                  "--store-full-id", "-f --supress-noise 2"])
def test_cli_sharded_two_ranks(two_ranks, case):
    """Rank 0 prints the device backend's stdout, rank 1 nothing."""
    _d, runs = two_ranks
    device, ranks = runs[case]
    assert [rc for rc, _out in ranks] == [0, 0]
    assert ranks[0][1] == device and ranks[1][1] == ""
    if case != "-p":
        assert len(device.splitlines()) > 0


def test_cli_sharded_precompute_writes_the_same_dat(two_ranks):
    """-p at 2 ranks: each .dat byte-equal to the device backend's."""
    d, _runs = two_ranks
    for block in ("block0.dat", "block1.dat"):
        dat = (d / "sharded" / block).read_bytes()
        assert dat == (d / "dev" / block).read_bytes() and dat


def test_cli_sharded_stays_on_the_gpu(reads, tmp_path, monkeypatch):
    """Without a GPU, --backend sharded at the CLI's default device
    raises rather than moving to the CPU or to gloo; under torchrun's
    environment, a LOCAL_RANK past the visible cards raises."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    write_fasta(tmp_path / "reads.fa", reads[:4])
    argv = ["-s", str(tmp_path / "reads.fa")] + CFG_FLAGS + SHARDED
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(argv)
    for name, value in (("WORLD_SIZE", "2"), ("RANK", "0"),
                        ("LOCAL_RANK", "0")):
        monkeypatch.setenv(name, value)
    with pytest.raises(RuntimeError, match="LOCAL_RANK 0 but torch sees"):
        sharded_comm("cuda")
