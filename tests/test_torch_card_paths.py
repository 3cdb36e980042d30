"""The port's paths on the card against the native binary and the pinned
goldens, line set by line set (``bench.lineset_sha256``).

``TorchOverlapper.overlap_self`` and the CLI on the primary workload
(also at ``--settings 2`` and ``3``), a repeat mix, lognormal10k,
filtered2k with its filter file (``-f``), an ultra-long mix, 24 reads
whose strands exceed a sketch chunk's ``CELLS``, and the CLI at sizes
where the kernels' scratch lives in device memory, each against the
native binary at the same flags; the Canu path against the JAX CLI's
goldens, with the device bloom membership and mode-2 weights against a
numpy evaluation; ``--backend sharded`` at 1 NCCL rank and 2 and 4 gloo
ranks sharing the card; EstimateROC with kernel 5 against the JAX
package's goldens; ``--backend oracle`` against the device CLI and
native; scale40k, scale100k and (marked ``slow``) repeat40k against the
native goldens.  After each main-path run a kernel the path needs must
have launched, so the CUDA path and not the plain one ran.

They need a CUDA card and skip without one.  On the card, where JAX is
absent and tests/conftest.py imports it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_card_paths.py

Imports nothing of JAX or of the JAX package.
"""

import contextlib
import hashlib
import io
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

import torch_card_inputs as ci

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif("not torch.cuda.is_available()",
                                 reason="needs a CUDA card")]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K1, H = 16, 512
# what a path launches: the strand pack and kernel 1 or 2 when it
# sketches (kernel 2 alone with a filter file), kernel 3 when it scores
SELF = ("pack_strands", "min_reduce_w1", "score_pairs")
WEIGHTED = ("pack_strands", "weighted_min_reduce", "score_pairs")


def check_launched(counts, need):
    missing = [k for k in need if counts[k] == 0]
    assert not missing, f"the path skipped {missing}: {counts}"


def run_path(ov, reads, need):
    """overlap_self twice, the launch counters reset before the first run
    and read after it; the lines, equal in both runs."""
    kern = ci.kernels()
    ci.reset_counters(kern)
    lines = ov.overlap_self(reads)
    check_launched(ci.read_counters(kern), need)
    assert ov.overlap_self(reads) == lines, "not deterministic"
    return lines


def cli_in_process(argv, need=()):
    """The port's CLI in this process (its launch counters count): its
    sorted stdout lines."""
    from mhap_tpu_torch.cli.main import main

    kern = ci.kernels()
    ci.reset_counters(kern)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main([str(a) for a in argv])
    assert rc == 0, f"CLI {argv} exited {rc}: {err.getvalue()[-3000:]}"
    check_launched(ci.read_counters(kern), need)
    return sorted(out.getvalue().splitlines())


def cli_process(argv, cmd=("-m", "mhap_tpu_torch.cli.main")):
    """A module of the port as a subprocess: its sorted stdout lines."""
    r = subprocess.run([sys.executable, *cmd, *map(str, argv)], cwd=REPO,
                       capture_output=True, text=True)
    assert r.returncode == 0, f"{cmd} {argv}: {r.stderr[-3000:]}"
    return sorted(r.stdout.splitlines())


def native(bench, reads, extra=()):
    """(lines, line-set sha256) of the native binary on the reads."""
    return bench.bench_native(reads, extra=[str(x) for x in extra])[1:4:2]


def check_native(bench, lines, reads, extra=(), n=None):
    want = native(bench, reads, extra)
    assert (len(lines), bench.lineset_sha256(lines)) == want
    assert lines and n in (None, len(lines))


@pytest.fixture(scope="module")
def bench():
    import bench

    return bench


@pytest.fixture(scope="module")
def reads(bench):
    return bench.make_reads()


@pytest.fixture(scope="module")
def lognormal10k(bench):
    """(reads, placements, genome length, lines, stats) of lognormal10k
    through overlap_self (two runs), checked against native."""
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    reads, places, glen = bench.make_reads_placed(10_000,
                                                  seed=bench.SEED + 1)
    ov = TorchOverlapper(device="cuda")
    lines = run_path(ov, reads, SELF)
    check_native(bench, lines, reads, n=ci.EXPECTED_LOGNORMAL10K)
    return reads, places, glen, lines, dict(ov.stats)


@pytest.fixture(scope="module")
def filtered2k(bench, tmp_path_factory):
    """(reads, filter path, counts, lines) of filtered2k through
    overlap_self with its filter file, checked against native -f."""
    from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    reads, path = ci.filtered2k(bench, str(tmp_path_factory.mktemp("f2k")))
    fc = ci.read_filter(path)
    ov = TorchOverlapper(device="cuda",
                         kmer_filter=VectorFrequencyFilter(fc, "cuda"))
    lines = run_path(ov, reads, WEIGHTED)
    check_native(bench, lines, reads, ("-f", path), ci.EXPECTED_FILTERED2K)
    return reads, path, fc, lines


def test_primary(bench, reads):
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    lines = run_path(TorchOverlapper(device="cuda"), reads, SELF)
    check_native(bench, lines, reads, n=ci.EXPECTED_PRIMARY)


@pytest.mark.parametrize("settings", [2, 3])
def test_cli_settings(settings, bench, reads, tmp_path):
    """The CLI's presets against native at the flags each expands to."""
    from mhap_tpu_torch.cli.options import PRESETS

    fa = ci.write_fasta(str(tmp_path / "primary.fa"), reads)
    lines = cli_in_process(["-s", fa, "--settings", settings], SELF)
    check_native(bench, lines, reads,
                 [x for kv in PRESETS[settings].items() for x in kv])


def test_repeat_mix(bench):
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    mix = ci.repeat_mix(bench)
    check_native(bench, run_path(TorchOverlapper(device="cuda"), mix,
                                 WEIGHTED), mix)


def test_lognormal10k(lognormal10k):
    assert len(lognormal10k[3]) == ci.EXPECTED_LOGNORMAL10K


def test_filtered2k(filtered2k):
    """The library's lines equal native's with -f, and the CLI's
    ``-s reads.fa -f kmers.txt`` prints the same lines."""
    reads, path, _fc, lines = filtered2k
    fa = ci.write_fasta(os.path.join(os.path.dirname(path), "reads.fa"),
                        reads)
    assert cli_process(["-s", fa, "-f", path]) == lines


def test_ultra_long_mix(bench):
    """16 reads of 131-400 kb and 1,024 of 2.9 kb; lines with a long read
    among them."""
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    reads = ci.ultra_long_mix(bench)
    lines = run_path(TorchOverlapper(device="cuda"), reads,
                     ("min_reduce_w1",) + WEIGHTED)
    check_native(bench, lines, reads)
    long_ids = set(range(1, 17))
    assert any({int(x) for x in line.split()[:2]} & long_ids
               for line in lines)


def test_cells_budget_cut(bench):
    """24 reads of 380-403 kb: their 48 strands exceed CELLS, so
    sketch_reads cuts them into a chunk filled to the budget and a rest."""
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    reads = ci.ultra_long_mix(bench, seed=4245, genome_len=2_000_000,
                              lens=list(range(380_000, 404_000, 1_000)))
    ov = TorchOverlapper(device="cuda")
    chunks = ci.record_chunks(ov)
    lines = run_path(ov, reads, WEIGHTED)
    check_native(bench, lines, reads)
    # the first of run_path's two runs
    shapes = [tuple(c.shape) for c, _ in chunks[:len(chunks) // 2]]
    assert len(shapes) >= 2, shapes
    assert max(r * w for r, w in shapes) <= ov.CELLS
    assert any(r * w > ov.CELLS - w for r, w in shapes), shapes


@pytest.mark.parametrize("name, size", [("ordered-sketch-size", 10000),
                                        ("num-hashes", 2048),
                                        ("num-hashes", 16384)])
def test_cli_device_memory_sizes(name, size, bench, reads, tmp_path):
    """The CLI where the kernels' scratch lives in device memory (kernel
    3 at S = 10,000 on 24 reads of 12-20 kb; kernel 2 at H = 2,048 on the
    primary reads; kernels 1 and 2 at H = 16,384 on the repeat mix), each
    such kernel launched, against native at the same flags."""
    from mhap_tpu_torch.ops.minhash_kernels import plan as minhash_plan
    from mhap_tpu_torch.ops.scorer_kernels import plan as scorer_plan

    if name == "ordered-sketch-size":
        rs = ci.ultra_long_mix(bench, seed=4246, genome_len=120_000,
                               lens=[12_000 + 347 * i for i in range(24)])
        need, plans = ("score_pairs",), [scorer_plan(size)]
    elif size == 2048:
        rs, need = reads, ("weighted_min_reduce", "score_pairs")
        plans = [minhash_plan(2, size)]
    else:
        rs, need = ci.repeat_mix(bench), ("min_reduce_w1",) + WEIGHTED
        plans = [minhash_plan(1, size), minhash_plan(2, size)]
    assert all(p["path"] == "device" for p in plans), plans
    fa = ci.write_fasta(str(tmp_path / "reads.fa"), rs)
    extra = ("--" + name, size)
    check_native(bench, cli_in_process(["-s", fa, *extra], need), rs, extra)


@pytest.fixture(scope="module")
def canu(bench, tmp_path_factory):
    """The Canu path's CLI as subprocesses on canu_input's 2,048 reads:
    -p blocks/ -q dats/, then -s dats/block0.dat -q querydir/
    (block1.dat) at Canu's flags."""
    d = str(tmp_path_factory.mktemp("canu"))
    reads, blocks, kpath = ci.canu_input(bench, d, ci.CANU_READS)
    flags = ["-f", kpath, "--supress-noise", "2", "--repeat-weight", "0.9",
             "--repeat-idf-scale", "10"]
    dats, qdir = os.path.join(d, "dats"), os.path.join(d, "querydir")
    os.makedirs(dats)
    os.makedirs(qdir)
    cli_process(["-p", blocks, "-q", dats] + flags)
    shutil.copy(os.path.join(dats, "block1.dat"), qdir)
    argv_sq = ["-s", os.path.join(dats, "block0.dat"), "-q", qdir] + flags
    return types.SimpleNamespace(
        dir=d, reads=reads, blocks=blocks, kpath=kpath, flags=flags,
        dats=dats, argv_sq=argv_sq, lines=cli_process(argv_sq))


def test_canu_cli(bench, canu):
    """Each .dat and the -s .dat -q lines sha256-equal to the JAX CLI's;
    -s block0.fa -q block1.fa the same lines but for the query ids a .dat
    keeps from -p time."""
    for b, want in ci.CANU_DAT_SHA256.items():
        with open(os.path.join(canu.dats, b), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == want, b
    assert len(canu.lines) == ci.CANU_LINES
    assert bench.lineset_sha256(canu.lines) == ci.CANU_SHA256
    half = ci.CANU_READS // 2
    fa_lines = cli_process(["-s", os.path.join(canu.blocks, "block0.fa"),
                            "-q", os.path.join(canu.blocks, "block1.fa")]
                           + canu.flags)
    as_dat = sorted(" ".join([str(int(x[0]) - half)] + x[1:])
                    if int(x[0]) > half else line
                    for line, x in ((ln, ln.split()) for ln in fa_lines))
    assert as_dat == canu.lines


def test_canu_precompute_in_process(canu):
    """-p in this process writes the subprocess's .dat bytes; the device
    bloom filter's words equal the host's, and every chunk's device
    membership and mode-2 weights equal a numpy evaluation; kernel 2
    equals its plain version on the first chunk's 4 rows of largest
    weight."""
    from mhap_tpu_torch.cli.main import build_overlapper, run_precompute
    from mhap_tpu_torch.cli.options import build_options
    from mhap_tpu_torch.io.fasta import open_text
    from mhap_tpu_torch.io.filter import FrequencyCounts
    from mhap_tpu_torch.ops import minhash as mh
    from mhap_tpu_torch.ops import murmur3
    from mhap_tpu_torch.ops.minhash_kernels import weighted_min_reduce

    dats2 = os.path.join(canu.dir, "dats2")
    os.makedirs(dats2)
    o = build_options()
    assert o.process(["-p", canu.blocks, "-q", dats2] + canu.flags)
    ov = build_overlapper(o)
    vf = ov.kmer_filter
    with open_text(canu.kpath) as f:
        fc_host = FrequencyCounts(f, 1e-5, 0.9, 2, False, 10.0, True,
                                  use_bloom=True)
    assert bool((fc_host.valid.words == vf.valid.words.cpu()).all())
    chunks = ci.record_chunks(ov)
    kern = ci.kernels()
    ci.reset_counters(kern)
    with contextlib.redirect_stderr(io.StringIO()):
        run_precompute(o, ov)
    check_launched(ci.read_counters(kern), WEIGHTED[:2])
    for b in ci.CANU_DAT_SHA256:
        with open(os.path.join(canu.dats, b), "rb") as f1, \
                open(os.path.join(dats2, b), "rb") as f2:
            assert f1.read() == f2.read(), b
    words = vf.valid.words.cpu().numpy()
    dev = torch.device("cuda")
    for i, (codes, lens) in enumerate(chunks):
        h = murmur3.kmer_hashes_128(codes, K1)
        v = (torch.arange(h.shape[1], device=dev)[None]
             < (lens - K1 + 1)[:, None])
        if i == 0:
            args = ci.weighted_inputs(h, v, ov._weights)
            top = torch.topk(args[1].max(dim=1).values, 4).indices
            sub = tuple(a[top] for a in args)
            assert torch.equal(weighted_min_reduce(*sub, H),
                               mh.weighted_min_reduce_ref(*sub, H))
        g = mh.sort_and_count(h, v)
        keys, cnt = g["h"][g["first"]], g["count"][g["first"]]
        member = ci.bloom_member_np(words, vf.valid.bit_size,
                                    vf.valid.num_hashes, keys.cpu().numpy())
        assert (vf.member(keys).cpu().numpy() == member).all(), i
        assert (vf.weights(keys, cnt, 0.9).cpu().numpy()
                == ci.mode2_weights_np(fc_host, member, keys.cpu().numpy(),
                                       cnt.cpu().numpy())).all(), i


def test_canu_query_in_process(canu):
    """-s block0.dat -q querydir in this process, twice: the subprocess's
    lines each time, kernel 3 launched."""
    from mhap_tpu_torch.cli.main import build_overlapper, run_overlap
    from mhap_tpu_torch.cli.options import build_options

    o = build_options()
    assert o.process(canu.argv_sq)
    ov = build_overlapper(o)
    kern = ci.kernels()
    for run in range(2):
        ci.reset_counters(kern)
        out = io.StringIO()
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            run_overlap(o, ov)
        check_launched(ci.read_counters(kern), ("score_pairs",))
        assert sorted(out.getvalue().splitlines()) == canu.lines, run


@pytest.mark.parametrize("mode", [1, 2])
def test_canu_library(mode, bench, canu, tmp_path):
    """overlap_self with the Canu filter against the JAX package's
    goldens: mode 1 (the exact set) on the 2,048 reads, mode 2 with the
    bloom on the recipe at 512 reads."""
    from mhap_tpu_torch.io.fasta import open_text
    from mhap_tpu_torch.io.filter import FrequencyCounts
    from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    if mode == 1:
        rs, kpath = canu.reads, canu.kpath
        want = ci.CANU_MODE1_LINES, ci.CANU_MODE1_SHA256
    else:
        rs, _, kpath = ci.canu_input(bench, str(tmp_path), 512)
        want = ci.CANU512_LINES, ci.CANU512_SHA256
    with open_text(kpath) as f:
        fc = FrequencyCounts(f, 1e-5, 0.9, mode, False, 10.0, True,
                             use_bloom=mode == 2)
    lines = run_path(TorchOverlapper(device="cuda", kmer_filter=(
        VectorFrequencyFilter(fc, "cuda"))), rs, WEIGHTED)
    assert (len(lines), bench.lineset_sha256(lines)) == want


def test_sharded_one_nccl_rank(bench, lognormal10k):
    """ShardedOverlapper at world size 1 on NCCL: lognormal10k's lines and
    integer stats equal the single-card run's."""
    from mhap_tpu_torch.parallel import comm
    from mhap_tpu_torch.parallel.sharded import _INT_STATS, ShardedOverlapper

    reads, _, _, want, stats = lognormal10k
    with comm.single("nccl", "cuda:0") as c:
        ov = ShardedOverlapper(c)
        lines = run_path(ov, reads, ("min_reduce_w1", "score_pairs"))
        got = ov.total_stats()
    assert lines == want
    assert {k: got[k] for k in _INT_STATS} == {k: stats[k]
                                               for k in _INT_STATS}


def test_sharded_gloo_ranks_share_the_card(bench, reads, filtered2k):
    """2 and 4 gloo ranks on cuda:0 (collectives through the host) on the
    primary reads, and 2 on filtered2k with its filter: rank 0's lines
    equal native's, the other ranks print none, each rank launched the
    path's kernels, and the postings split evenly at every D."""
    from mhap_tpu_torch.parallel.jobs import KERNELS
    from mhap_tpu_torch.parallel import launch
    from mhap_tpu_torch.parallel.jobs import run_jobs

    reads_f, path, fc, _ = filtered2k
    want = {"primary": (native(bench, reads), ("min_reduce_w1",
                                               "score_pairs")),
            "filtered2k": (native(bench, reads_f, ("-f", path)),
                           ("weighted_min_reduce", "score_pairs"))}
    runs = {2: [("primary", dict(reads=reads)),
                ("filtered2k", dict(reads=reads_f, filter=fc))],
            4: [("primary", dict(reads=reads))]}
    postings = {}
    for D, jobs in runs.items():
        res = launch.run_ranks(run_jobs, D, backend="gloo",
                               devices=["cuda:0"] * D,
                               args=([job for _n, job in jobs],))
        for j, (name, _job) in enumerate(jobs):
            ranks = [r[j] for r in res]
            lines = ranks[0]["lines"]
            assert (len(lines), bench.lineset_sha256(lines)) == \
                want[name][0], (D, name)
            assert not any(r["lines"] for r in ranks[1:])
            check_launched({k: sum(r["launches"][k] for r in ranks)
                            for k in KERNELS}, want[name][1])
            if name == "primary":
                postings[D] = [r["index_bytes"] for r in ranks]
    assert all(len(set(b)) == 1 for b in postings.values()), postings
    assert len({sum(b) for b in postings.values()}) == 1, postings


def test_sharded_cli(bench, reads, tmp_path):
    """--backend sharded as a subprocess at world size 1, and under
    torchrun with one NCCL rank a card where there are 2 or more."""
    fa = ci.write_fasta(str(tmp_path / "primary.fa"), reads)
    want = native(bench, reads)
    lines = cli_process(["--backend", "sharded", "-s", fa])
    assert (len(lines), bench.lineset_sha256(lines)) == want
    n = torch.cuda.device_count()
    if n >= 2:
        lines = cli_process(
            ["--standalone", f"--nproc-per-node={n}", "-m",
             "mhap_tpu_torch.cli.main", "--backend", "sharded", "-s", fa],
            cmd=("-m", "torch.distributed.run"))
        assert (len(lines), bench.lineset_sha256(lines)) == want


@pytest.mark.parametrize("name", ["lognormal10k", "filtered2k"])
def test_estimate_roc(name, request, bench, tmp_path):
    """EstimateROC(min_ovl_len=500, num_trials=2000, do_dp=True) on the
    card as bench_config_lognormal runs it: its counts, rates, disputed
    pairs and the sha256 of kernel 5's outputs on them equal the JAX
    package's goldens (filtered2k's 1,713 disputed pairs go through
    kernel 5; lognormal10k has none)."""
    from mhap_tpu_torch.ops.swalign_kernels import sw_align_batch

    if name == "lognormal10k":
        reads, places, glen, lines, _ = request.getfixturevalue(name)
    else:
        reads, places, glen, _ = ci.filtered2k_placed(bench)
        lines = request.getfixturevalue(name)[3]
    files = ci.roc_files(bench, str(tmp_path), reads, places, glen, lines)
    sw_align_batch.launches = 0
    roc, disputed = ci.estimate_roc_recorded(files)[:2]
    assert (sw_align_batch.launches > 0) == bool(disputed)
    got = dict(tp=roc.tp, fn=roc.fn, tn=roc.tn, fp=roc.fp,
               sensitivity=roc.sensitivity(), specificity=roc.specificity(),
               ppv=roc.ppv, disputed=len(disputed), sw_sha256=None)
    if disputed:
        got["sw_sha256"] = ci.sw_sha256(sw_align_batch(
            *roc.dp_batch_inputs(disputed)[0]))
    want = ci.ROC_GOLDENS[name]
    assert got == {k: want[k] for k in got}


def test_estimate_roc_cli(lognormal10k, bench, tmp_path):
    """The tool's entry point (per-pair DP, as in JAX) on lognormal10k:
    its stdout equals the JAX tool's."""
    reads, places, glen, lines, _ = lognormal10k
    files = ci.roc_files(bench, str(tmp_path), reads, places, glen, lines)
    r = subprocess.run([sys.executable, "-m",
                        "mhap_tpu_torch.tools.estimate_roc", *files, "500",
                        "2000", "true"], cwd=REPO, capture_output=True,
                       text=True)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.splitlines() == ci.ROC_GOLDENS["lognormal10k"]["cli"]


def test_backend_oracle(bench, reads, tmp_path):
    """``--backend oracle`` on the first ORACLE_READS primary reads: its
    line set equals the device CLI's and the native binary's."""
    sub = reads[:ci.ORACLE_READS]
    fa = ci.write_fasta(str(tmp_path / "oracle.fa"), sub)
    oracle = cli_process(["-s", fa, "--backend", "oracle"])
    assert oracle and oracle == cli_process(["-s", fa])
    check_native(bench, oracle, sub)


@pytest.mark.parametrize("name", ["scale40k", "scale100k",
                                  pytest.param("repeat40k",
                                               marks=pytest.mark.slow)])
def test_scale(name, bench, tmp_path):
    """bench.py's scale inputs (80,000 and 200,000 store rows: past the
    65,535 where the JAX package leaves its narrow vote; repeat40k's
    29.5 M lines with its filter file) through overlap_self, and scale40k
    through the CLI, each line set sha256-equal to the native golden."""
    from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
    from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

    reads, fpath = ci.scale_input(bench, name, str(tmp_path))
    want = ci.SCALE_GOLDENS[name]
    if fpath is None:
        ov, need = TorchOverlapper(), SELF
    else:
        ov, need = TorchOverlapper(kmer_filter=VectorFrequencyFilter(
            ci.read_filter(fpath), "cuda")), WEIGHTED
    lines = run_path(ov, reads, need)
    assert (len(lines), bench.lineset_sha256(lines)) == want
    del lines, ov
    if name == "scale40k":
        fa = ci.write_fasta(str(tmp_path / "scale40k.fa"), reads)
        lines = cli_in_process(["-s", fa], need)
        assert (len(lines), bench.lineset_sha256(lines)) == want


def test_nothing_of_jax_imported():
    assert not [m for m in sys.modules
                if m.split(".")[0] in ("jax", "mhap_tpu")]
