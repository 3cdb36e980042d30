"""The traffic generator: same sizes for every seed, same files for one."""

import os

import numpy as np

from benchmark import generators as gen
from benchmark import traffic
from benchmark.cell import Cell

TINY = {"reads": 40, "check": {"queries": 4}}


def test_quantile_lengths_same_multiset_every_seed():
    a = gen.quantile_lengths(1000, 1400, 0.45, 500, 9000, traffic.rng(1, 1))
    b = gen.quantile_lengths(1000, 1400, 0.45, 500, 9000,
                             traffic.rng(2**31 + 5, 1))
    assert sorted(a) == sorted(b)
    assert not np.array_equal(a, b)
    assert a.min() >= 500 and a.max() <= 9000
    assert abs(np.median(a) - 1400) < 20


def test_placed_reads_follow_the_genome():
    rng = np.random.default_rng(3)
    genome = rng.integers(0, 4, 20_000)
    reads, places = gen.placed_reads(rng, [600, 900], [10, 5000], genome,
                                     err=0.0)
    for r, (s, e) in zip(reads, places):
        assert r == bytes(gen.BASES[genome[s:e]]).decode()


def test_repeat_genome_holds_its_copies():
    g = gen.repeat_seeded_genome(np.random.default_rng(4), 50_000, 100,
                                 repeat_len=500,
                                 copies=range(0, 50_000, 5_000))
    s = "".join("ACGT"[b] for b in g)
    counts = {}
    for i in range(len(s) - 15):
        counts[s[i:i + 16]] = counts.get(s[i:i + 16], 0) + 1
    assert max(counts.values()) >= 5


def test_make_inputs_is_a_function_of_the_seed(tmp_path, canu):
    config, mix = canu
    spec = dict(mix, **TINY)
    outs = []
    for d in ("a", "b"):
        os.makedirs(tmp_path / d)
        outs.append(traffic.make_inputs(spec, config, 2**31 + 9,
                                        str(tmp_path / d)))
    a, b = outs
    assert a.reads == b.reads and a.blocks == [(0, 20), (20, 40)]
    assert a.bases == sum(map(len, a.reads))
    with open(a.filter_path) as f, open(b.filter_path) as g:
        assert f.read() == g.read()
    assert a.job_argv[-4] == "-s" and a.job_argv[-3].endswith("block0.dat")
    # -p a block at a time: block 0 into the store's directory, the rest
    # into the query directory the job reads
    assert [v[-4:] for v in a.setup_argvs] == [
        ["-p", str(tmp_path / "a" / "fasta" / "block0"),
         "-q", str(tmp_path / "a" / "dat")],
        ["-p", str(tmp_path / "a" / "fasta" / "block1"),
         "-q", a.job_argv[-1]]]
    os.makedirs(tmp_path / "c")
    c = traffic.make_inputs(spec, config, 7, str(tmp_path / "c"))
    assert c.reads != a.reads
    assert sorted(map(len, c.reads)) == sorted(map(len, a.reads))


def test_every_seed_gets_the_same_layout():
    spec = {"reads": 30, "length": {"median": 1400, "sigma": 0.45,
                                    "min": 500, "max": 9000},
            "coverage": 5.0, "error": 0.0,
            "repeat": {"length": 300, "share": 0.2}}
    a, ga = traffic.make_reads(spec, 1)
    b, gb = traffic.make_reads(spec, 2)
    assert len(ga) == len(gb) and not np.array_equal(ga, gb)
    assert sorted(map(len, a)) == sorted(map(len, b))
    # error-free reads: each read sits where its twin of the other seed
    # does, so the overlaps between reads are the same
    def starts(reads, g):
        s = "".join("ACGT"[x] for x in g)
        return sorted(s.find(r) for r in reads)
    assert starts(a, ga) == starts(b, gb)
    # with blocks, each block holds reads from the same starts
    spec["blocks"] = 2
    a, ga = traffic.make_reads(spec, 1)
    b, gb = traffic.make_reads(spec, 2)
    assert starts(a[:15], ga) == starts(b[:15], gb)
    assert starts(a[15:], ga) == starts(b[15:], gb)


def test_self_job_reads_one_fasta(tmp_path):
    cell = Cell("default.self40k")
    inp = traffic.make_inputs(dict(cell.traffic, **TINY), cell.config, 5,
                              str(tmp_path))
    assert inp.job_argv[-2:] == ["-s", str(tmp_path / "fasta" / "block0" /
                                             "block0.fa")]
    assert inp.setup_argvs == [] and inp.filter_path is None
    with open(inp.job_argv[-1]) as f:
        assert f.read().count(">") == 40
