"""A job's M4 lines as one buffer (``mhap_tpu_torch/csrc/m4_lines.cc``,
``utils/native.m4_format`` and ``m4_sort``, ``io/formats.M4Lines``):
formatting byte-equal to Python's ``%`` line on random columns, on the
``%.6f`` ties and boundaries, on raw counts up to 2^53 and on the values
that take snprintf; order equal to ``sorted()``; the CLI's stdout equal
to the route of per-line ``%`` formatting, Python's ``sorted`` and one
write a line, for M4 and ``--paf``, with ``--store-full-id``, in query
mode and at ``--backend sharded``; the job's two line counters."""

import contextlib
import io
import math

import numpy as np
import pytest
import torch

from mhap_tpu_torch.cli import main as cli
from mhap_tpu_torch.io import formats
from mhap_tpu_torch.io.formats import M4Lines, m4_to_paf
from mhap_tpu_torch.pipeline import overlapper
from mhap_tpu_torch.utils import native, trace

torch.set_num_threads(1)

FLAGS = ["--num-hashes", "64", "--ordered-sketch-size", "128",
         "--num-min-matches", "2"]


def python_lines(qid, cid, err, raw, qrc, a1, a2, ql, crc, b1, b2, cl):
    """The %-format loop of ``TorchOverlapper._format``."""
    return ["%s %s %.6f %.6f %d %d %d %d %d %d %d %d" % t
            for t in zip(*[np.asarray(c).tolist() for c in
                           (qid, cid, err, raw, qrc, a1, a2, ql, crc, b1,
                            b2, cl)])]


def columns(rng, n, err, raw, big=10 ** 5):
    ints = [rng.integers(-big, big, n) for _ in range(8)]
    return (rng.integers(1, 10 ** 7, n), rng.integers(1, 10 ** 7, n), err,
            raw, *ints)


def assert_native_equals_python(cols):
    got = str(native.m4_format(*cols), "utf-8")
    want = python_lines(*cols)
    assert got.split("\n")[:-1] == want
    assert got == "".join(line + "\n" for line in want)


def test_random_columns_byte_equal():
    rng = np.random.default_rng(11)
    n = 20_000
    assert_native_equals_python(columns(
        rng, n, rng.random(n), (rng.random(n) * 3000).round(0)))


def test_int64_extremes_byte_equal():
    big = np.array([0, 1, -1, 9, 10, -10, 2 ** 63 - 1, -2 ** 63,
                    10 ** 18, -10 ** 18 + 1], np.int64)
    n = len(big)
    cols = (big, big[::-1].copy(), np.full(n, 0.25), np.full(n, 7.0),
            *[np.roll(big, k) for k in range(8)])
    assert_native_equals_python(cols)


def ulp_neighbours(xs):
    xs = np.asarray(xs, np.float64)
    return np.concatenate([np.nextafter(xs, -np.inf), xs,
                           np.nextafter(xs, np.inf)])


def unit_values():
    """err in [0, 1]: the 2^-k family (test_format_native.py's ties),
    every odd / 128 (x 10^6 ends in exactly .5: round half to even), 0,
    1, subnormals, and each x.xxxxxx5 decimal boundary with its 1-ulp
    neighbours."""
    rng = np.random.default_rng(3)
    two_k = [0.5 ** k for k in range(0, 1075)]
    ties = [j / 128 for j in range(1, 128, 2)]
    specials = [0.0, 1.0, 5e-324, 1e-320, 2.2250738585072014e-308,
                2.225073858507201e-308, 1e-7, 4.9e-7, 5e-7, 1.5e-6,
                0.9999995, 0.00000049999999, 0.328125, 0.1, 0.7]
    bounds = (rng.integers(0, 10 ** 6, 3000) + 0.5) / 1e6
    xs = ulp_neighbours(two_k + ties + specials + bounds.tolist())
    return xs[(xs >= 0.0) & (xs <= 1.0)]


def test_unit_err_ties_and_boundaries_byte_equal():
    err = unit_values()
    n = len(err)
    rng = np.random.default_rng(4)
    assert_native_equals_python(columns(rng, n, err, err[::-1].copy()))


def test_raw_counts_up_to_2_53_and_fallbacks_byte_equal():
    """Exact integers below 2^53 take the integer path; 2^53 and past it,
    non-integral counts, negatives, -0.0, NaN and inf take snprintf, as
    do err values outside [0, 1]."""
    rng = np.random.default_rng(5)
    ints = [0.0, 1.0, 2.0 ** 52, 2.0 ** 53 - 1, 2.0 ** 53, 2.0 ** 53 + 2,
            2.0 ** 60, 1e300, 1.7976931348623157e308,
            *rng.integers(0, 2 ** 53, 200).astype(np.float64).tolist()]
    odd = [45.5, 0.1, 2.0 ** 52 + 0.5, 1e-300, -3.0, -0.0, -0.5,
           -1.7976931348623157e308, math.nan, -math.nan, math.inf,
           -math.inf, 0.0000005, 1234.0000005]
    raw = np.array(ints + odd)
    err = np.array([-0.0, 1.0000000000000002, 2.5, -1e-300, math.nan,
                    -math.nan, math.inf, -math.inf, 1e300, -0.5]
                   * (len(raw) // 10 + 1))[:len(raw)]
    assert_native_equals_python(columns(rng, len(raw), err, raw))
    assert_native_equals_python(columns(rng, len(raw), raw, err))


def test_threads_and_a_short_first_buffer_give_the_same_bytes(monkeypatch):
    """Rows split over threads (one per 16,384 rows at most), and the
    retry when the first buffer's guess of bytes a line is too small."""
    rng = np.random.default_rng(9)
    n = 70_000
    cols = columns(rng, n, rng.random(n), rng.integers(0, 900, n) * 1.0)
    want = "".join(line + "\n" for line in python_lines(*cols))
    for threads in (1, 2, 4, 7):
        assert str(native.m4_format(*cols, threads=threads), "utf-8") == want
    monkeypatch.setattr(native, "M4_LINE_GUESS", 8)
    assert str(native.m4_format(*cols, threads=4), "utf-8") == want
    lines = want.split("\n")[:-1]
    order = "".join(line + "\n" for line in sorted(lines))
    data = np.frombuffer(want.encode(), np.uint8)
    for threads in (1, 3, 4):
        assert str(native.m4_sort(data, threads=threads), "utf-8") == order


def test_empty_batch():
    z = np.zeros(0)
    assert native.m4_format(*[z] * 12).size == 0
    assert M4Lines().tolist() == [] and len(M4Lines()) == 0
    assert M4Lines().sorted().tolist() == []
    assert M4Lines.of([]).count == 0


def emitted(ids):
    """Lines in the vote's order: query by query, candidates ascending
    numerically."""
    return ["%d %d 0.100000 5.000000 0 1 2 3 0 4 5 6" % (q, c)
            for q in ids for c in ids if c != q]


@pytest.mark.parametrize("ids", [[9, 10], [99, 100], [999, 1000],
                                 [1, 9, 10, 11, 99, 100, 101, 999, 1000,
                                  1001, 12345, 123456]])
def test_order_across_digit_counts(ids):
    lines = emitted(ids)
    got = M4Lines.of(lines).sorted()
    assert got.tolist() == sorted(lines) and got.count == len(lines)


def test_order_of_prefixes_and_odd_bytes():
    """A line before its extensions, lines shorter than the 8-byte key,
    equal keys, a tab (below the newline), an empty line and UTF-8 header
    strings (Python orders code points, UTF-8 bytes the same), also past
    the key."""
    lines = ["1 2", "1 2 3", "1 23", "1 2\t3", "1 2 ", "", "1",
             "12345678", "123456789", "12345678 9", "1234567", "12345679",
             "é 1", "z 1", "中 2", "\U0001f600 3", "aé",
             "1 2 3", "read/1/0_300 read/10/0_99", "read/1/0_300 read/2",
             "12345678é", "12345678z", "12345678\t", "12345678 é1",
             "12345678 z"]
    rng = np.random.default_rng(6)
    for _ in range(5):
        shuffled = [lines[i] for i in rng.permutation(len(lines))]
        assert M4Lines.of(shuffled).sorted().tolist() == sorted(lines)


def test_order_of_two_batches_concatenated():
    """``overlap_query``'s two batches, and a random large set."""
    rng = np.random.default_rng(8)
    n = 30_000
    cols = columns(rng, n, rng.random(n), rng.integers(0, 500, n) * 1.0)
    a = M4Lines(native.m4_format(*cols), n)
    b = M4Lines.of(emitted([7, 8, 9, 10, 11]))
    both = (a + b).sorted()
    assert both.tolist() == sorted(a.tolist() + b.tolist())
    assert len(both) == n + b.count
    assert (M4Lines() + b.tolist()).tolist() == b.tolist()
    assert list(b) == b.tolist()


class Writes:
    def __init__(self):
        self.parts = []
        self.write = self.parts.append


@pytest.mark.parametrize("paf", [False, True])
def test_write_lines_one_write_for_a_batch_or_a_list(paf):
    lines = emitted([3, 10, 200])
    for given in (lines, M4Lines.of(lines)):
        out = Writes()
        assert formats.write_lines(given, out, paf) == len(lines)
        want = [m4_to_paf(line) if paf else line for line in lines]
        assert out.parts == ["".join(line + "\n" for line in want)]
    out = Writes()
    assert formats.write_lines(M4Lines(), out) == 0 and out.parts == []


# ---- the CLI against the route of per-line % formatting and sorted() ----

def parent_route(mp):
    """The route before the buffer: Python's %-format on every batch,
    Python's sorted() and one write a line."""
    def m4_format(*cols):
        text = "".join(line + "\n" for line in python_lines(*cols))
        return np.frombuffer(text.encode(), np.uint8)

    def m4_sort(data):
        lines = sorted(str(data, "utf-8").split("\n")[:-1])
        text = "".join(line + "\n" for line in lines)
        return np.frombuffer(text.encode(), np.uint8)

    def write_lines(lines, out, paf=False):
        n = 0
        for line in lines:
            out.write((m4_to_paf(line) if paf else line) + "\n")
            n += 1
        return n

    mp.setattr(overlapper, "m4_format", m4_format)
    mp.setattr(formats, "m4_sort", m4_sort)
    mp.setattr(cli, "write_lines", write_lines)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """(box file, query file): reads of 150-900 bases at 5 % error off a
    10 kb genome, named so that ids and full ids cross digit counts."""
    rng = np.random.default_rng(21)
    genome = rng.choice(list("ACGT"), 10_000)
    d = tmp_path_factory.mktemp("m4_lines")
    paths = []
    for name, count in (("box.fa", 110), ("query.fa", 30)):
        out = []
        for i in range(count):
            n = int(rng.integers(150, 900))
            p = int(rng.integers(0, len(genome) - n))
            r = genome[p:p + n].copy()
            flip = rng.random(n) < 0.05
            r[flip] = rng.choice(list("ACGT"), int(flip.sum()))
            out.append(f">{name[0]}/{i}/0_{n} x\n{''.join(r)}\n")
        (d / name).write_text("".join(out))
        paths.append(str(d / name))
    return paths


def stdout_of(argv, made=None):
    build = cli.build_overlapper

    def keep(*a, **k):
        ov = build(*a, **k)
        if made is not None:
            made.append(ov)
        return ov

    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "build_overlapper", keep)
        with contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(io.StringIO()):
            assert cli.main(argv, device="cpu") == 0
    return out.getvalue()


CASES = {
    "self": [],
    "self --paf": ["--paf"],
    "self --store-full-id": ["--store-full-id"],
    "query": ["-q", "{query}"],
    "query --paf --store-full-id": ["-q", "{query}", "--paf",
                                    "--store-full-id"],
    "query --no-self": ["-q", "{query}", "--no-self"],
    "self --backend sharded": ["--backend", "sharded"],
    "query --paf --backend sharded": ["-q", "{query}", "--paf",
                                      "--backend", "sharded"],
}


@pytest.mark.parametrize("case", list(CASES))
def test_cli_stdout_equal_to_the_per_line_route(fasta, case):
    box, query = fasta
    argv = ["-s", box, *[a.format(query=query) for a in CASES[case]],
            *FLAGS]
    got = stdout_of(argv)
    with pytest.MonkeyPatch.context() as mp:
        parent_route(mp)
        want = stdout_of(argv)
    assert got == want and got.count("\n") > 20


@pytest.mark.parametrize("full_id", [False, True])
def test_job_counters_count_the_lines_of_each_route(fasta, full_id):
    box, query = fasta
    argv = ["-s", box, "-q", query, *FLAGS] + (
        ["--store-full-id"] if full_id else [])
    made = []
    trace.enable()
    try:
        text = stdout_of(argv, made)
        job, = trace.jobs()
    finally:
        trace.disable()
        trace.reset()
    ov, = made
    lines = text.count("\n")
    assert lines == ov.stats["matches_processed"] > 0
    native_n, python_n = (0, lines) if full_id else (lines, 0)
    assert job.counters["m4_lines_native"] == native_n
    assert job.counters["m4_lines_python"] == python_n
    assert "m4_lines_native" not in ov.stats
