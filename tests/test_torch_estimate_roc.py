"""The port's EstimateROC (mhap_tpu_torch/tools/estimate_roc.py) against
the JAX package's on the same files: JavaRandom's gold values, the
interval index's strict bounds, the reverse complement, the four overlap
formats, and tp, fn, tn, fp and PPV equal (not merely close) in
Monte-Carlo mode, full mode, per-pair DP (the native library) and batched
DP (the port's plain Smith-Waterman on the CPU against the JAX scan).
The overlaps come from the port's TorchOverlapper on the CPU, on a
fixture like tests/test_tools.py's roc_setup (14 reads x 4 kb).  A second
truth file misplaces three reads, as a mapping into the wrong copy of a
repeat would: their real overlaps are then disputed and go to DP."""

import contextlib
import io

import numpy as np
import pytest
import torch

from mhap_tpu.oracle.seq import reverse_complement as rc_jax
from mhap_tpu.tools import estimate_roc as jax_roc
from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper
from mhap_tpu_torch.tools import estimate_roc as port_roc
from mhap_tpu_torch.utils.intervals import IntervalIndex, range_overlap
from mhap_tpu_torch.utils.javarandom import JavaRandom
from mhap_tpu_torch.utils.seq import reverse_complement

torch.set_num_threads(1)

MISPLACED = (2, 6, 11)  # reads whose truth placement is moved away
TRIALS_DP = 8  # PPV trials of the batched test: 3 disputed pairs of 4 kb


def _mutate(rng, s, err=0.10):
    arr = np.array(list("ACGT"))
    out = []
    for ch in s:
        r = rng.random()
        if r < err * 0.4:
            out.append(ch)
            out.append(str(arr[rng.integers(0, 4)]))
        elif r < err * 0.7:
            pass
        elif r < err:
            out.append(str(arr[rng.integers(0, 4)]))
        else:
            out.append(ch)
    return "".join(out)


@pytest.fixture(scope="module")
def roc_setup(tmp_path_factory):
    """tests/test_tools.py's roc_setup recipe: a 30 kb genome, 14 reads of
    4 kb with known placements; the truth M4, the port's overlaps and the
    FASTA on disk, and a truth with MISPLACED moved by 12 kb."""
    tmp = tmp_path_factory.mktemp("roc_torch")
    rng = np.random.default_rng(21)
    arr = np.array(list("ACGT"))
    genome = "".join(arr[rng.integers(0, 4, 30000)])
    reads, places = [], []
    for _ in range(14):
        pos = int(rng.integers(0, 25000))
        reads.append(_mutate(rng, genome[pos:pos + 4000]))
        places.append((pos, pos + 4000))
    fasta = tmp / "reads.fa"
    fasta.write_text("".join(f">{i + 1}\n{r}\n" for i, r in enumerate(reads)))

    def truth(path, places):
        with open(path, "w") as f:
            for i, (s, e) in enumerate(places):
                ln = len(reads[i])
                f.write(f"{i + 1} chr1 -{ln} 95.0 0 0 {ln} {ln} 0 {s} {e} "
                        f"30000 254\n")
        return str(path)

    moved = [((s + 12000) % 26000, (s + 12000) % 26000 + 4000)
             if i in MISPLACED else (s, e) for i, (s, e) in enumerate(places)]
    lines = TorchOverlapper(dict(num_hashes=256, ordered_sketch_size=1024,
                                 num_min_matches=2),
                            device="cpu").overlap_self(reads)
    ovl = tmp / "ovls.mhap"
    ovl.write_text("\n".join(lines) + "\n")
    return dict(truth=truth(tmp / "truth.m4", places),
                moved=truth(tmp / "moved.m4", moved), ovl=str(ovl),
                fasta=str(fasta), reads=reads, lines=lines)


def both(setup, truth="truth", **kw):
    """The JAX and the port's estimators, loaded from the same files."""
    out = []
    for g in (jax_roc.EstimateROC(**kw),
              port_roc.EstimateROC(device="cpu", **kw)):
        g.process_reference(setup[truth])
        g.load_fasta(setup["fasta"])
        g.process_overlaps(setup["ovl"])
        out.append(g)
    return out


def counts(g):
    return (g.tp, g.fn, g.tn, g.fp, g.ppv, g.sensitivity(),
            g.specificity())


def test_javarandom_gold_values():
    """Published java.util.Random(0) outputs, and the JAX copy's stream."""
    r = JavaRandom(0)
    assert r.next_int32() == -1155484576
    assert r.next_int32() == -723955400
    r = JavaRandom(0)
    assert r.next_double() == pytest.approx(0.730967787376657, abs=1e-15)
    assert JavaRandom(42).next_int32() == -1170105035
    from mhap_tpu.utils.javarandom import JavaRandom as JaxRandom

    a, b = JavaRandom(0), JaxRandom(0)
    for bound in (1, 2, 7, 64, 1000, 10_000, (1 << 30) + 1):
        assert [a.next_int(bound) for _ in range(50)] == \
            [b.next_int(bound) for _ in range(50)]
    assert a.next_boolean() == b.next_boolean()


def test_interval_index_strict_bounds():
    """Interval.java semantics: strictly exclusive intersection."""
    ix = IntervalIndex()
    assert ix.get(0, 10) == [] and ix.stab(5) == []
    ix.add(10, 20, "a")
    ix.add(30, 40, "b")
    assert ix.get(15, 35) == ["a", "b"]
    assert ix.get(20, 30) == []           # touching endpoints don't count
    assert ix.get(19, 31) == ["a", "b"]
    assert ix.stab(15) == ["a"]
    assert ix.stab(10) == []              # exclusive contains
    assert len(ix) == 2
    assert range_overlap(0, 10, 5, 20) == 6
    assert range_overlap(0, 10, 20, 30) == -9
    assert range_overlap(10, 0, 20, 5) == 6


def test_reverse_complement_iupac():
    s = "ACGTNBDHKMRSVWYacgt-X*"
    assert reverse_complement(s) == rc_jax(s)
    assert reverse_complement("ACGTN") == "NACGT"
    assert reverse_complement("acgt") == "tgca"  # unknowns unchanged


PARSE_LINES = [
    "2 1 0.15 98.0 0 10 3000 4000 1 5 2995 4000",
    "1 2 N 100 -50 12.0 0.0",
    "1 2 I -100 50 12.0",
    "1/0_4000 2 -500 99.0 0 0 4000 4000 0 10 3980 4000 254",
    "1/0_4000 ref,2 -500 99.0 0 0 4000 4000 1 10 3980 4000 254",
    "  1  2 n   [ 4,746.. 8,108] x [     0.. 3,896] :   <  982 diffs  "
    "( 34 trace pts)",
    "  3  4 c   [ 100.. 3,000] x [ 20.. 2,900] :   <  50 diffs  "
    "( 3 trace pts)",
    "1 2 x y",
]


@pytest.mark.parametrize("line", PARSE_LINES)
def test_overlap_format_parsers(roc_setup, line):
    """CA ovl 6/7 columns, MHAP 12, BLASR M4 13, DAligner bracketed, and a
    line no format takes: every Overlap field equal to the JAX parser's."""
    g = port_roc.EstimateROC(device="cpu")
    j = jax_roc.EstimateROC()
    g.data_seq = j.data_seq = roc_setup["reads"]
    got, want = g.parse_overlap_line(line), j.parse_overlap_line(line)
    assert vars(got) == vars(want)
    assert got.get_size() == want.get_size()


def test_overlap_parsers_on_overlapper_lines(roc_setup):
    g = port_roc.EstimateROC(device="cpu")
    j = jax_roc.EstimateROC()
    g.data_seq = j.data_seq = roc_setup["reads"]
    assert len(roc_setup["lines"]) >= 10
    for line in roc_setup["lines"]:
        assert vars(g.parse_overlap_line(line)) == \
            vars(j.parse_overlap_line(line))


@pytest.mark.parametrize("truth", ["truth", "moved"])
def test_monte_carlo_equal(roc_setup, truth):
    j, g = both(roc_setup, truth, min_ovl_len=1500, num_trials=300)
    for e in (j, g):
        e.estimate_sensitivity()
        e.estimate_specificity()
        e.estimate_ppv()
    assert counts(g) == counts(j)
    assert g.tp > 0 and g.tn > 0


@pytest.mark.parametrize("truth,do_dp", [("truth", False), ("moved", True)])
def test_full_mode_equal(roc_setup, truth, do_dp):
    j, g = both(roc_setup, truth, min_ovl_len=1500, num_trials=0,
                do_dp=do_dp)
    j.full_estimate()
    g.full_estimate()
    assert counts(g) == counts(j)
    assert g.tp > 0


def test_per_pair_dp_equal(roc_setup):
    """do_dp with per-pair adjudication by the native library."""
    j, g = both(roc_setup, "moved", min_ovl_len=1500, num_trials=60,
                do_dp=True)
    rescued = [g._compute_dp(o.id1, o.id2)
               for o in list(g.ovl_info.values())[:6]]
    assert rescued == [j._compute_dp(o.id1, o.id2)
                       for o in list(j.ovl_info.values())[:6]]
    assert any(rescued)
    j.estimate_ppv(batch_dp=False)
    g.estimate_ppv(batch_dp=False)
    assert g.ppv == j.ppv


def test_batched_dp_equal(roc_setup):
    """batch_dp=True: the disputed pairs (reads of MISPLACED) through the
    port's Smith-Waterman on the CPU and through the JAX scan; the same
    pairs, the same decisions, the same PPV."""
    j, g = both(roc_setup, "moved", min_ovl_len=1500, num_trials=TRIALS_DP,
                do_dp=True)
    seen = {}
    for name, e in (("jax", j), ("port", g)):
        def record(pairs, name=name, batch=e._compute_dp_batch):
            seen[name] = (list(pairs), batch(pairs))
            return seen[name][1]

        e._compute_dp_batch = record
        e.estimate_ppv(batch_dp=True)
    pairs, got = seen["port"]
    assert pairs == seen["jax"][0] and len(pairs) >= 2
    assert {int(x) - 1 for p in pairs for x in p} & set(MISPLACED)
    np.testing.assert_array_equal(got, seen["jax"][1])
    assert got.any()
    assert g.ppv == j.ppv


def test_cli_equal(roc_setup):
    """The tool's entry point (per-pair native DP), its stdout lines equal
    to the JAX tool's."""
    argv = [roc_setup["moved"], roc_setup["ovl"], roc_setup["fasta"],
            "1500", "60", "true"]
    outs = []
    for main in (jax_roc.main, lambda a: port_roc.main(a, device="cpu")):
        buf, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
            assert main(list(argv)) == 0
        outs.append(buf.getvalue().splitlines())
    assert outs[0] == outs[1] and len(outs[1]) == 3


def test_cuda_device_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError):
        port_roc.EstimateROC()
