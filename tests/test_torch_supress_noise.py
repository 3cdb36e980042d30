"""The port's --supress-noise 1 and 2 on the CPU against the JAX package:
filtered stores against a strict ``TpuOverlapper`` at repeat weights 0.9
(tf-idf), 1.5 (counts) and -1 (legacy), with the exact set and with the
bloom (the bloom and the weights pointwise: tests/test_torch_bloom.py).
Same numpy-seeded inputs on both sides; every compared value is an
integer: exact."""

import numpy as np
import pytest
import torch

from mhap_tpu.oracle.filter import FrequencyCounts as JaxFC
from mhap_tpu.pipeline.freqfilter import VectorFrequencyFilter as JaxVFF
from mhap_tpu.pipeline.overlapper import TpuOverlapper
from mhap_tpu_torch.io.filter import FrequencyCounts
from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

from test_filter import make_filter_file

torch.set_num_threads(1)

CFG = dict(num_hashes=64, ordered_sketch_size=256, num_min_matches=2)
COLS = ("minhash", "ordered_h", "ordered_p", "ordered_m", "num_kmers")


@pytest.fixture(scope="module")
def inputs(synthetic_reads):
    """Ten noisy reads and a filter file of their most frequent 16-mers,
    some listed below the cutoff, and a line with no fraction (a valid
    k-mer that is no file k-mer)."""
    _genome, rs, _pos = synthetic_reads
    reads = list(rs[:10])
    lines = make_filter_file(reads)
    lines.append(reads[2][100:116])
    return reads, lines


def jax_fc(lines, rw, ru, bloom):
    offset = rw if 0.0 <= rw < 1.0 else 0.0
    return JaxFC(iter(lines), 1.0e-5, offset, ru, False, 3.0, True,
                 use_bloom=bloom)


def port_fc(lines, rw, ru, bloom):
    offset = rw if 0.0 <= rw < 1.0 else 0.0
    return FrequencyCounts(iter(lines), 1.0e-5, offset, ru, False, 3.0,
                           True, use_bloom=bloom)


def strict(ov):
    ov._defer_flags = False
    ov.ROWS = 32
    ov.pair_chunk = 64
    return ov


@pytest.mark.parametrize("ru", [1, 2])
@pytest.mark.parametrize("rw", [0.9, 1.5, -1.0])
def test_filtered_store_bit_equal(inputs, ru, rw):
    """Mode 1 drops a read whose k-mers are all outside the file (at
    every repeat weight, 1.5 included); the bloom and the exact set give
    the same store here, and both equal the JAX package's."""
    reads, lines = inputs
    reads = reads + ["ACGT" * 100]
    js = strict(TpuOverlapper(dict(CFG, repeat_weight=rw), kmer_filter=JaxVFF(
        jax_fc(lines, rw, ru, True)))).sketch_reads(reads)
    for bloom in (True, False):
        ts = TorchOverlapper(dict(CFG, repeat_weight=rw), device="cpu",
                             kmer_filter=VectorFrequencyFilter(
                                 port_fc(lines, rw, ru, bloom), "cpu")
                             ).sketch_reads(reads)
        for name in ("header_id", "is_fwd", "length"):
            np.testing.assert_array_equal(getattr(ts, name),
                                          getattr(js, name))
        for name in COLS:
            np.testing.assert_array_equal(ts.host(name), getattr(js, name))
    assert (11 in ts.header_id) == (ru == 2)
