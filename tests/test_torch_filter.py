"""The port's k-mer filter path (-f, --supress-noise 0) on the CPU
against the JAX package: the filter-file reader against
``oracle.filter.FrequencyCounts``, the weights against
``VectorFrequencyFilter.weights``, filtered stores against a strict
``TpuOverlapper(kmer_filter=...)`` in every weight mode, and the line
sets of the library and the CLI.  Same numpy-seeded inputs on both
sides; all compared values are integers or float64 bits: exact."""

import gzip

import numpy as np
import pytest
import torch

from mhap_tpu.cli import main as jax_cli
from mhap_tpu.oracle import sketch as osk
from mhap_tpu.oracle.filter import FrequencyCounts as JaxFC
from mhap_tpu.pipeline.freqfilter import VectorFrequencyFilter as JaxVFF
from mhap_tpu.pipeline.overlapper import TpuOverlapper
from mhap_tpu_torch.cli.main import build_overlapper
from mhap_tpu_torch.cli.main import main as cli_main
from mhap_tpu_torch.cli.main import run_overlap
from mhap_tpu_torch.cli.options import build_options
from mhap_tpu_torch.io.filter import FrequencyCounts
from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

from test_filter import make_fc, make_filter_file

# one intra-op thread: the plain kernels run many small tensor ops,
# whose thread pools stall for seconds each when test processes
# share the cores
torch.set_num_threads(1)

CFG = dict(num_hashes=64, ordered_sketch_size=256, num_min_matches=2)
MODES = [(rw, no_tf) for rw in (0.9, 0.5, -1.0, 1.0)
         for no_tf in (False, True)]
COLS = ("minhash", "ordered_h", "ordered_p", "ordered_m", "num_kmers")
STATS = ("matches_processed", "sequences_searched", "elements_processed",
         "sequences_hit", "sequences_fully_compared")


def port_fc(lines, rw=0.9, no_tf=False, canonical=True):
    offset = rw if 0.0 <= rw < 1.0 else 0.0
    return FrequencyCounts(iter(lines), 1.0e-5, offset, 0, no_tf, 3.0,
                           canonical)


@pytest.fixture(scope="module")
def inputs(synthetic_reads):
    """Ten noisy reads, a read with 4 tandem copies of a 20-mer (counts
    up to 4: weights up to 12 in tf-idf mode, within the JAX weight-cap
    rungs it compiles first), and a 300 bp read over {A, C} whose every
    16-mer is a file k-mer (each its own canonical form, so a read's
    forward hash meets the file's key): all its weights are 0 in legacy
    mode, and the read is dropped.  The filter file also lists one k-mer
    twice and another as its reverse complement."""
    _genome, rs, _pos = synthetic_reads
    reads = list(rs[:10])
    reads.append(reads[0][:800] + "ACGTACGGTCAGTCATGCAT" * 4 + reads[1][:800])
    rng = np.random.default_rng(21)
    popular = "".join(np.array(list("AC"))[rng.integers(0, 2, 300)])
    reads.append(popular)
    lines = make_filter_file(reads[:11])
    lines += [f"{popular[i:i + 16]}\t0.001" for i in range(285)]
    mer = lines[1].split()[0]
    rc = mer[::-1].translate(str.maketrans("ACGT", "TGCA"))
    lines += [f"{mer}\t0.0005", f"{rc}\t0.0007"]
    return reads, lines


def test_reader_matches_oracle(inputs):
    _reads, lines = inputs
    for canonical in (True, False):
        want = JaxVFF(JaxFC(iter(lines), 1.0e-5, 0.9, 0, False, 3.0,
                            canonical))
        fc = port_fc(lines, canonical=canonical)
        keys = fc.keys.numpy().view(np.uint64)
        o = np.argsort(keys)
        np.testing.assert_array_equal(keys[o], want.frac_keys)
        np.testing.assert_array_equal(fc.sidf.numpy()[o], want.frac_sidf)
        assert fc.max_value == want.fc.max_value
        assert np.all(np.diff(fc.keys.numpy()) > 0)


@pytest.mark.parametrize("rw,no_tf", MODES)
def test_weights_match_vector_filter(inputs, rw, no_tf):
    """Every k-mer of the reads plus every file k-mer, at counts 1..10,000
    (far past the JAX device LUT's 128 columns)."""
    reads, lines = inputs
    keys = np.unique(np.concatenate(
        [osk.sequence_kmer_hashes_128(r, 16).astype(np.uint64)
         for r in reads[9:]] + [JaxVFF(make_fc(lines)).frac_keys]))
    rng = np.random.default_rng(7)
    counts = rng.integers(1, 10_001, len(keys))
    counts[:200] = np.arange(1, 201)
    want = JaxVFF(make_fc(lines, rw, 0, no_tf)).weights(keys, counts, rw)
    vf = VectorFrequencyFilter(port_fc(lines, rw, no_tf), "cpu")
    got = vf.weights(torch.from_numpy(keys.view(np.int64)),
                     torch.from_numpy(counts), rw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.max() > 128 or rw < 0 or no_tf


def strict(ov):
    """A JAX overlapper with no deferred sketch flags (stats of one pass),
    a 32-row sketch tile and 64-pair scorer chunks (its defaults, 512
    and 512, pad these 24 rows and few pairs)."""
    ov._defer_flags = False
    ov.ROWS = 32
    ov.pair_chunk = 64
    return ov


def jax_overlapper(lines, rw, no_tf):
    return strict(TpuOverlapper(
        dict(CFG, repeat_weight=rw),
        kmer_filter=JaxVFF(make_fc(lines, rw, 0, no_tf))))


def port_overlapper(lines, rw, no_tf):
    return TorchOverlapper(dict(CFG, repeat_weight=rw), device="cpu",
                           kmer_filter=VectorFrequencyFilter(
                               port_fc(lines, rw, no_tf), "cpu"))


@pytest.mark.parametrize("rw,no_tf", MODES)
def test_filtered_store_bit_equal(inputs, rw, no_tf):
    reads, lines = inputs
    js = jax_overlapper(lines, rw, no_tf).sketch_reads(reads)
    ts = port_overlapper(lines, rw, no_tf).sketch_reads(reads)
    for name in ("header_id", "is_fwd", "length"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    for name in COLS:
        np.testing.assert_array_equal(ts.host(name), getattr(js, name))
    # legacy drops the all-popular read (id 12), the other modes keep it
    assert (12 in ts.header_id) == (rw >= 0)


@pytest.fixture(scope="module")
def cli_run(inputs, tmp_path_factory):
    """The JAX CLI's self run with -f (a gzipped filter file) on a strict
    overlapper: (argv, its stdout lines, its overlapper's stats)."""
    import contextlib
    import io

    reads, lines = inputs
    d = tmp_path_factory.mktemp("cli")
    fa = d / "reads.fa"
    fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    kf = d / "kmers.txt.gz"
    with gzip.open(kf, "wt") as f:
        f.write("\n".join(lines) + "\n")
    argv = ["-s", str(fa), "-f", str(kf), "--num-hashes", "64",
            "--ordered-sketch-size", "256", "--num-min-matches", "2"]
    made = []
    get_overlapper = jax_cli._get_overlapper

    def get_strict(*a, **kw):
        made.append(strict(get_overlapper(*a, **kw)))
        return made[-1]

    out = io.StringIO()
    try:
        jax_cli._get_overlapper = get_strict
        with contextlib.redirect_stdout(out):
            assert jax_cli.main(argv) == 0
    finally:
        jax_cli._get_overlapper = get_overlapper
    return argv, out.getvalue().splitlines(), dict(made[0].stats)


def test_filtered_lines_and_stats(inputs, cli_run):
    reads, lines = inputs
    ov = port_overlapper(lines, 0.9, False)
    got = ov.overlap_self(reads)
    assert got == cli_run[1] and len(got) > 5
    for key in STATS:
        assert ov.stats[key] == cli_run[2][key], key


def test_cli_filter_run_gives_jax_cli_lines(cli_run, capsys):
    """The port's CLI (on a CPU overlapper) prints the JAX CLI's lines."""
    o = build_options()
    assert o.process(cli_run[0])
    run_overlap(o, build_overlapper(o, device="cpu"))
    assert capsys.readouterr().out.splitlines() == cli_run[1]


def test_supress_noise_1_2_not_ported(inputs, tmp_path, capsys):
    """--supress-noise 1/2 are ported now: the reader keeps every file
    line's k-mer, and the CLI runs both modes (their lines against the
    JAX CLI's: tests/test_torch_dat.py), each with other lines than mode
    0 on eight of the reads."""
    reads, lines = inputs
    for ru in (1, 2):
        fc = FrequencyCounts(iter(lines), 1e-5, 0.9, ru, False, 3.0, True)
        assert fc.valid.numel() >= len(fc.keys) > 0
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads[:8])))
    kf = tmp_path / "kmers.txt"
    kf.write_text("\n".join(lines) + "\n")
    out = []
    for ru in (0, 1, 2):
        assert cli_main(["-s", str(fa), "-f", str(kf), "--num-hashes", "64",
                         "--ordered-sketch-size", "256", "--num-min-matches",
                         "2", "--supress-noise", str(ru)], device="cpu") == 0
        out.append(capsys.readouterr().out.splitlines())
    assert out[0] and out[1] != out[0] and out[2] != out[0]
