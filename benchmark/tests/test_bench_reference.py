"""The plain reference against the port run on the CPU, at tiny sizes:
the same M4 lines, and the float32 control not."""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from benchmark import compare, traffic
from benchmark.cell import Cell
from benchmark.reference import murmur3 as ref_m3
from benchmark.reference.filter import BloomFilter


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_lines(inputs):
    from mhap_tpu_torch.cli.main import main

    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        for argv in inputs.setup_argvs:
            assert main(argv, device="cpu") == 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert main(inputs.job_argv, device="cpu") == 0
    return out.getvalue()


@pytest.mark.parametrize("cell,reads", [("default.self40k", 70),
                                        ("canu", 100)])
def test_reference_equals_port(tmp_path, canu, cell, reads):
    config, mix = canu if cell == "canu" else (Cell(cell).config,
                                               Cell(cell).traffic)
    spec = dict(mix, reads=reads)
    inputs = traffic.make_inputs(spec, config, 2**31 + 3, str(tmp_path))
    text = port_lines(inputs)
    size = min(hi - lo for lo, hi in inputs.blocks)
    ids = list(range(1, size + 1))
    ref = compare.expected_lines(inputs, config["flags"], ids, "cpu")
    numbers = compare.judge([[text]], ref, ids)
    assert numbers["lines_expected"] > 50
    assert compare.passes(numbers), numbers
    low = compare.expected_lines(inputs, config["flags"], ids, "cpu",
                                 f32=True)
    control = compare.judge([["\n".join(low) + "\n"]], ref, ids)
    assert not compare.passes(control), control


def test_murmur3_equals_the_oracle():
    from mhap_tpu_torch.oracle import murmur3 as oracle

    rng = np.random.default_rng(11)
    codes = rng.choice(np.frombuffer(b"ACGTN", np.uint8), (3, 70))
    t = torch.from_numpy(codes)
    for k in (12, 16, 17):
        win = np.lib.stride_tricks.sliding_window_view(codes, k, axis=1)
        want128 = oracle.hash_kmers_128(win.reshape(-1, k))
        want32 = oracle.hash_kmers_32(win.reshape(-1, k))
        assert np.array_equal(ref_m3.hash128_windows(t, k).numpy().ravel(),
                              want128.view(np.int64))
        assert np.array_equal(ref_m3.hash32_windows(t, k).numpy().ravel(),
                              want32.view(np.int32))


def test_bloom_equals_the_oracle():
    from mhap_tpu_torch.oracle.filter import GuavaBloomFilter

    keys = np.random.default_rng(12).integers(-2**63, 2**63 - 1, 300)
    want = GuavaBloomFilter(300)
    for k in keys:
        want.add(int(k) & (2**64 - 1))
    got = BloomFilter(300)
    got.put(torch.from_numpy(keys))
    assert np.array_equal(got.words.numpy().view(np.uint64), want.words)
    probe = np.concatenate([keys, np.arange(1000)])
    assert np.array_equal(
        got.contains(torch.from_numpy(probe)).numpy(),
        want.contains_vec(probe.view(np.uint64)))


def test_sample_takes_the_longest_read_of_each_block(tmp_path, canu):
    config, mix = canu
    spec = dict(mix, reads=60)
    inputs = traffic.make_inputs(spec, config, 21, str(tmp_path))
    ids = compare.sample_ids(inputs, 5)
    for lo, hi in inputs.blocks:
        lens = [len(r) for r in inputs.reads[lo:hi]]
        assert int(np.argmax(lens)) + 1 in ids
    assert len(ids) == 5
    os.makedirs(tmp_path / "again")
    again = traffic.make_inputs(spec, config, 21, str(tmp_path / "again"))
    assert compare.sample_ids(again, 5) == ids
