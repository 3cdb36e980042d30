"""Long reads on the port against the JAX package's windowed sketcher.

The port sketches a read of any length on its one dense path, with chunks
cut to ``TorchOverlapper.CELLS`` row x width cells; the JAX overlapper
streams reads of ``LONG_READ_THRESHOLD`` bases or more through
``_sketch_long`` (set here to 8,192 bases and 4,096-base windows, as
tests/test_long_reads.py does).  On the inputs of that test, unfiltered
and filtered, the store columns must be bit-equal and the line sets
equal; a small cell budget splits the port's chunks down to single
rows.
"""

import numpy as np
import pytest
import torch

from mhap_tpu.pipeline.freqfilter import VectorFrequencyFilter as JaxVFF
from mhap_tpu.pipeline.overlapper import TpuOverlapper
from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

from test_filter import make_fc, make_filter_file
from test_torch_filter import port_fc, strict

# one intra-op thread: the plain kernels run many small tensor ops,
# whose thread pools stall for seconds each when test processes
# share the cores
torch.set_num_threads(1)

CFG = dict(num_hashes=64, ordered_sketch_size=256, num_min_matches=2)
CELLS = 24_576  # one 20 kb row, or six 4 kb rows, per chunk
COLS = ("minhash", "ordered_h", "ordered_p", "ordered_m", "num_kmers")


def random_dna(rng, n):
    return "".join(np.array(list("ACGT"))[rng.integers(0, 4, n)])


@pytest.fixture(scope="module")
def reads():
    """tests/test_long_reads.py's inputs: a 20 kb read with three reads
    overlapping it or not, and a 13.5 kb read whose 2.5 kb repeat crosses
    the JAX windows (repeated k-mers: the weighted kernel)."""
    rng = np.random.default_rng(52)
    genome = random_dna(rng, 30000)
    out = [genome[:20000], genome[15000:19000], genome[500:4000],
           random_dna(rng, 3000)]
    rng = np.random.default_rng(51)
    base = random_dna(rng, 9000)
    out.append(base + base[:2500] + random_dna(rng, 2000))
    return out


@pytest.fixture(scope="module", params=["unfiltered", "filtered"])
def runs(request, reads):
    jkw, tkw = {}, {}
    if request.param == "filtered":
        lines = make_filter_file(reads)
        jkw["kmer_filter"] = JaxVFF(make_fc(lines))
        tkw["kmer_filter"] = VectorFrequencyFilter(port_fc(lines), "cpu")
    jov = strict(TpuOverlapper(CFG, **jkw))
    jov.LONG_READ_THRESHOLD = 8192
    jov.long_window = 4096
    tov = TorchOverlapper(CFG, device="cpu", **tkw)
    tov.CELLS = CELLS
    chunks = []
    sketch_chunk = tov._sketch_chunk

    def spy(codes, lens):
        chunks.append(codes.shape)
        return sketch_chunk(codes, lens)

    tov._sketch_chunk = spy
    ts = tov.sketch_reads(reads)
    first = list(chunks)  # the chunks of one sketch_reads
    return (jov.sketch_reads(reads), jov.overlap_self(reads), ts,
            tov.overlap_self(reads), first)


def test_long_read_store_bit_equal(runs):
    js, _, ts, _, chunks = runs
    assert ts.length.max() >= 20000
    for name in ("header_id", "is_fwd", "length"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))
    for name in COLS:
        np.testing.assert_array_equal(ts.host(name), getattr(js, name))
    # the budget cut the 10 rows into chunks of at most CELLS cells, the
    # 20 kb and 13.5 kb rows into chunks of one row
    assert all(r * w <= CELLS or r == 1 for r, w in chunks)
    assert sum(r for r, _ in chunks) == 10
    assert [r for r, w in chunks if w >= 13500] == [1, 1, 1, 1]


def test_long_read_lines_equal(runs):
    _, jlines, _, tlines, _ = runs
    assert tlines == jlines
    assert len(tlines) >= 2
