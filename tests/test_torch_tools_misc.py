"""The port's host utilities and tools against the JAX package's:
MersenneTwisterFast streams (ints, bounded ints, doubles, gaussians),
RandomSequenceGenerator output, the seqstats functions, the stdout of
``python -m mhap_tpu_torch.tools.<name>`` against ``python -m
mhap_tpu.tools.<name>`` on the same arguments (kmer_stat_simulator in
both argument forms, get_histogram_stats, alignment_try), and the
multi-host layout: host_read_shard over a grid of (n, pid, nproc),
host_card_grid against the device grid of make_host_chip_mesh, and
initialize_from_env on a one-rank gloo group.  All exact."""

import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest

from mhap_tpu.parallel import multihost as jmh
from mhap_tpu.utils import mersenne as jmt
from mhap_tpu.utils import seqgen as jsg
from mhap_tpu.utils import seqstats as jss
from mhap_tpu_torch.parallel import multihost as tmh
from mhap_tpu_torch.utils import mersenne as tmt
from mhap_tpu_torch.utils import seqgen as tsg
from mhap_tpu_torch.utils import seqstats as tss

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("seed", [0, 4357, 5489, -3, 2**40 + 7])
def test_mersenne_streams_equal_to_jax(seed):
    t, j = tmt.MersenneTwisterFast(seed), jmt.MersenneTwisterFast(seed)
    for _ in range(700):  # past one 624-word regeneration
        assert t.next_int32() == j.next_int32()
    for n in (1, 2, 7, 8, 10, 1000, 2**30, 2**31 - 1):
        assert [t.next_int(n) for _ in range(20)] == \
            [j.next_int(n) for _ in range(20)]
    assert [t.next_double() for _ in range(50)] == \
        [j.next_double() for _ in range(50)]
    assert [t.next_gaussian() for _ in range(51)] == \
        [j.next_gaussian() for _ in range(51)]
    t.set_seed(seed + 1)
    j.set_seed(seed + 1)
    assert t._next32() == j._next32()
    with pytest.raises(ValueError):
        t.next_int(0)


def test_seqgen_equal_to_jax():
    for seed in (None, 0, 11):
        t, j = tsg.RandomSequenceGenerator(seed), \
            jsg.RandomSequenceGenerator(seed)
        s = t.generate_random_sequence(3000)
        assert s == j.generate_random_sequence(3000)
        assert t.add_pacbio_error(s) == j.add_pacbio_error(s)
        assert t.add_error(s, 0.05, 0.04, 0.03) == \
            j.add_error(s, 0.05, 0.04, 0.03)
    for bad in ((-0.1, 0, 0), (0.5, 0.5, 0.5)):
        with pytest.raises(ValueError):
            t.add_error("ACGT", *bad)


def test_seqstats_equal_to_jax():
    rng = np.random.default_rng(3)
    g = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 301)])
    for rev in (False, True):
        for frame in (0, 1, 2):
            assert tss.to_protein(g, rev, frame) == \
                jss.to_protein(g, rev, frame)
    assert tss.to_protein("ATG-GCCTAAG") == jss.to_protein("ATG-GCCTAAG")
    for w in (10, 60, 80):
        assert tss.convert_to_fasta(g, w) == jss.convert_to_fasta(g, w)
    a, b = rng.standard_normal(30), rng.standard_normal(30)
    for fn in ("mean", "std"):
        assert getattr(tss, fn)(a) == getattr(jss, fn)(a)
    assert tss.pearson_corr(a, b) == jss.pearson_corr(a, b)
    assert tss.pearson_corr([1.0], [2.0]) == jss.pearson_corr([1.0], [2.0])
    assert tss.linear_regression(a, b) == jss.linear_regression(a, b)


def run_tool(pkg, name, args):
    r = subprocess.run([sys.executable, "-m", f"{pkg}.tools.{name}",
                        *args], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    return r.returncode, r.stdout


@pytest.fixture(scope="module")
def tool_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    rng = np.random.default_rng(12)
    genome = "".join(np.array(list("ACGT"))[rng.integers(0, 4, 9000)])
    (d / "ref.fa").write_text(f">chr1\n{genome[:5000]}\n>chr2\n"
                              f"{genome[5000:]}N\n")
    (d / "skip.txt").write_text("".join(
        f"{genome[p:p + 12]} 9\n" for p in range(0, 3000, 37)))
    (d / "hist.txt").write_text("".join(
        f"{v} {c}\n" for v, c in ((1, 500), (2, 120), (3, 40), (5, 9),
                                  (9, 3), (40, 1))))
    return d


@pytest.mark.parametrize("name,args", [
    ("kmer_stat_simulator", ["3", "12", "500", "150", "0.05", "0.02",
                             "0.01"]),
    ("kmer_stat_simulator", ["2", "12", "400", "100", "0.04", "0.03",
                             "0.02", "true", "{d}/ref.fa", "{d}/skip.txt"]),
    ("kmer_stat_simulator", ["3", "300", "0.05", "0.02", "0.01"]),
    ("kmer_stat_simulator", ["2", "300", "0.05", "0.02", "0.01",
                             "{d}/ref.fa"]),
    ("kmer_stat_simulator", ["1"]),
    ("get_histogram_stats", ["{d}/hist.txt", "0.9"]),
    ("alignment_try", []),
])
def test_tool_stdout_equals_jax(tool_files, name, args):
    args = [a.format(d=tool_files) for a in args]
    got = run_tool("mhap_tpu_torch", name, args)
    want = run_tool("mhap_tpu", name, args)
    assert got == want
    assert got[1] or got[0] == 1


def test_host_read_shard_equal_to_jax():
    for n in (0, 1, 7, 100, 1001):
        for nproc in (1, 2, 3, 8):
            shards = [tmh.host_read_shard(n, pid, nproc)
                      for pid in range(nproc)]
            assert shards == [jmh.host_read_shard(n, pid, nproc)
                              for pid in range(nproc)]
            assert sum(s.stop - s.start for s in shards) == n
    assert tmh.host_read_shard(10) == jmh.host_read_shard(10)


def test_host_card_grid_matches_mesh():
    """One process of the tests' 8 CPU devices: make_host_chip_mesh is
    [1, 8] in device order, as host_card_grid(8, 8) is in rank order;
    more hosts reshape the same order, host-major."""
    mesh = jmh.make_host_chip_mesh()
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    grid = tmh.host_card_grid(jax.device_count(), jax.local_device_count())
    assert grid.shape == mesh.devices.shape == (1, 8)
    assert np.array_equal(grid, ids)
    assert np.array_equal(tmh.host_card_grid(8, 4),
                          ids.reshape(-1).reshape(2, 4))
    assert tmh.host_card_grid(12, 4)[2].tolist() == [8, 9, 10, 11]
    with pytest.raises(ValueError):
        tmh.host_card_grid(6, 4)


def test_initialize_from_env(monkeypatch):
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK", "LOCAL_RANK",
              "LOCAL_WORLD_SIZE", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert tmh.initialize_from_env("gloo") is None
    assert tmh.host_index() == (0, 1)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="1",
               RANK="0", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    c = tmh.initialize_from_env("gloo")
    try:
        assert (c.rank, c.world, c.backend, c.device.type) == \
            (0, 1, "gloo", "cpu")
    finally:
        c.close()
    monkeypatch.setenv("WORLD_SIZE", "8")
    monkeypatch.setenv("RANK", "5")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert tmh.host_index() == (1, 2)
    assert tmh.host_read_shard(10) == jmh.host_read_shard(10, 1, 2)
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    with pytest.raises(RuntimeError):
        tmh.initialize_from_env("gloo")
