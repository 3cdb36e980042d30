"""The sketch layer's strand pack (``ops/pack.py``, ``csrc/pack.cu``) and
``TorchOverlapper.sketch_reads`` against the host route they replaced,
kept here as the spec (``host_route``): each read upper-cased and encoded
on its own, its reverse complement by ``utils/seq.reverse_complement``
(the port's copy of Utils.rc, with its own table), each row copied
into a zero-padded chunk, the skip rules as a loop over the entries.

On seeded reads with lower case, IUPAC codes and N, lengths about
multiples of 64 and under k, reads dropped by --min-olap-length, both
strands and one, and chunks that end between a read's two strands: the
pack's rows, the chunks handed to ``_sketch_chunk`` and every column of
the store are equal, with and without a filter.  Reads outside ASCII take
``str.upper()`` on the host as before.  The ``cuda`` cases hold the kernel
bit-equal to the plain version, and the store on the card equal to the
CPU's, and skip without a card."""

from collections import Counter

import numpy as np
import pytest
import torch

from mhap_tpu_torch.io.filter import FrequencyCounts
from mhap_tpu_torch.ops.pack import pack_strands_ref
from mhap_tpu_torch.ops.pack_kernels import pack_strands
from mhap_tpu_torch.pipeline.freqfilter import VectorFrequencyFilter
from mhap_tpu_torch.pipeline.overlapper import SketchStore, TorchOverlapper
from mhap_tpu_torch.utils import trace
from mhap_tpu_torch.utils.seq import reverse_complement

# one intra-op thread: the plain kernels run many small tensor ops
torch.set_num_threads(1)

CFG = dict(num_hashes=64, ordered_sketch_size=128, min_olap_length=10)
# odd rows and few cells a chunk: chunks end between a read's strands,
# and the 2,000-base read takes a chunk of one row
ROWS, CELLS = 7, 3 * 512
LENGTHS = [0, 5, 9, 10, 11, 15, 16, 17, 63, 64, 65, 127, 128, 129, 191,
           192, 193, 2000]
IUPAC = list("NnRYKMSWBDHVrykmswbdhv")
COLS = ("minhash", "ordered_h", "ordered_p", "ordered_m", "num_kmers")


def seeded_reads(seed: int, n: int = 48) -> list[str]:
    """Reads off a 4 kb genome, ~30 % of bases lower case and ~3 % IUPAC
    codes, with LENGTHS among them; one tandem repeat (its 16-mers
    repeat: kernel 2's rows) and one of other ASCII bytes."""
    rng = np.random.default_rng(seed)
    genome = rng.choice(list("ACGT"), 4000)
    lens = LENGTHS + [int(x) for x in rng.integers(10, 500,
                                                   n - len(LENGTHS))]
    rng.shuffle(lens)
    out = []
    for n_ in lens:
        p = int(rng.integers(0, len(genome) - n_))
        r = genome[p:p + n_].copy()
        low = rng.random(n_) < 0.3
        r[low] = np.char.lower(r[low])
        odd = rng.random(n_) < 0.03
        r[odd] = rng.choice(IUPAC, int(odd.sum()))
        out.append("".join(r))
    return out + ["ACGTTGCAAC" * 30, "acgt-*09xyzu@[`{~" * 12]


def rc_codes(read: str) -> np.ndarray:
    """The reverse complement of the upper-cased read, as bytes."""
    return np.frombuffer(reverse_complement(read.upper()).encode("ascii"),
                         np.uint8)


def overlapper(kmer_filter=None, rows=ROWS, cells=CELLS):
    ov = TorchOverlapper(CFG, device="cpu", kmer_filter=kmer_filter)
    ov.ROWS, ov.CELLS = rows, cells
    return ov


def kmer_filter(reads, k=16):
    """A tf-idf filter of the reads' 30 commonest ACGT 16-mers."""
    c = Counter(m for r in reads for m in (r[i:i + k].upper()
                                          for i in range(len(r) - k + 1))
                if set(m) <= set("ACGT"))
    total = sum(c.values())
    rows = c.most_common(30)
    lines = [f"{len(c)} {len(rows)}"] + [f"{m}\t{n / total}"
                                         for m, n in rows]
    fc = FrequencyCounts(iter(lines), 1e-5, 0.9, 0, False, 3.0, True)
    return VectorFrequencyFilter(fc, "cpu")


def host_route(ov, reads, headers=None, offset=0, do_rc=True):
    """``sketch_reads`` as the host built its rows before the pack kernel:
    entries a read at a time, padded chunks, the skip loop."""
    cfg = ov.cfg
    k1, k2 = cfg["kmer_size"], cfg["ordered_kmer_size"]
    H, S = cfg["num_hashes"], cfg["ordered_sketch_size"]
    entries = []  # (header_id, is_fwd, header, codes)
    for i, r in enumerate(reads):
        if len(r) < cfg["min_olap_length"]:
            continue
        hid = i + 1 + offset
        hdr = headers[i] if headers is not None else None
        codes = np.frombuffer(r.upper().encode("ascii"), dtype=np.uint8)
        entries.append((hid, True, hdr, codes))
        if do_rc:
            entries.append((hid, False, hdr, rc_codes(r)))
    lens = np.asarray([len(e[3]) for e in entries], np.int64)
    N = len(entries)
    cols = [torch.empty((N, H), dtype=torch.int32),
            torch.empty((N, S), dtype=torch.int32),
            torch.empty((N, S), dtype=torch.int32),
            torch.empty((N,), dtype=torch.int32),
            torch.empty((N,), dtype=torch.int64)]
    order = np.argsort(lens, kind="stable")

    def width(j):
        return max(-(-int(lens[j]) // 64) * 64, k1, k2)

    s = 0
    while s < N:
        R = min(ov.ROWS, N - s)
        if R * width(order[s + R - 1]) > ov.CELLS:
            R = max(1, ov.CELLS // width(order[s + R - 1]))
        idx = order[s:s + R]
        codes = np.zeros((R, width(idx[-1])), np.uint8)
        for r, j in enumerate(idx):
            codes[r, :lens[j]] = entries[j][3]
        out = ov._sketch_chunk(torch.from_numpy(codes),
                               torch.from_numpy(lens[idx]))
        for col, val in zip(cols, out):
            col[torch.from_numpy(idx)] = val
        s += R
    mh_valid = cols[4].numpy() > 0
    keep = np.ones(N, bool)
    for j, (hid, fwd, _hdr, _c) in enumerate(entries):
        if not mh_valid[j]:
            keep[j] = False
            if fwd and do_rc and j + 1 < N and entries[j + 1][0] == hid:
                keep[j + 1] = False
    sel = np.nonzero(keep)[0]
    nk = np.maximum(lens[sel] - k2 + 1, 0).astype(np.int32)
    return SketchStore(
        header_id=np.asarray([entries[j][0] for j in sel], np.int64),
        is_fwd=np.asarray([entries[j][1] for j in sel], bool),
        length=lens[sel].astype(np.int32),
        headers=[entries[j][2] for j in sel],
        minhash=cols[0][sel], ordered_h=cols[1][sel], ordered_p=cols[2][sel],
        ordered_m=cols[3][sel], num_kmers=torch.from_numpy(nk))


def spy_chunks(ov):
    """Records the (codes, lengths) of each ``_sketch_chunk`` call."""
    chunks = []
    sketch_chunk = ov._sketch_chunk

    def spy(codes, lens):
        chunks.append((codes.clone(), lens.clone()))
        return sketch_chunk(codes, lens)

    ov._sketch_chunk = spy
    return chunks


def assert_same_store(got, want):
    assert len(got) == len(want) > 0
    for name in ("header_id", "is_fwd", "length"):
        g, w = getattr(got, name), getattr(want, name)
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.headers == want.headers
    for name in COLS:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def strand_rows(reads, do_rc):
    """The reads as one byte range, and each strand's row: (raw, start,
    length, fwd) and the host route's rows, a read at a time."""
    codes = [np.frombuffer(r.upper().encode("ascii"), np.uint8)
             for r in reads]
    raw = np.frombuffer("".join(reads).encode("ascii"), np.uint8)
    off = np.cumsum([0] + [len(r) for r in reads])
    start, length, fwd, rows = [], [], [], []
    for i, c in enumerate(codes):
        for f in (True, False) if do_rc else (True,):
            start.append(off[i])
            length.append(len(c))
            fwd.append(f)
            rows.append(c if f else rc_codes(reads[i]))
    t = [torch.tensor(x, dtype=torch.int64) for x in (start, length, fwd)]
    return (torch.from_numpy(raw.copy()), *t), rows


def padded(rows, width):
    out = np.zeros((len(rows), width), np.uint8)
    for i, c in enumerate(rows):
        out[i, :len(c)] = c
    return out


@pytest.mark.parametrize("do_rc", [True, False])
def test_pack_rows_equal_the_host_rows(do_rc):
    reads = seeded_reads(1)
    (raw, start, length, fwd), rows = strand_rows(reads, do_rc)
    width = -(-max(map(len, rows)) // 64) * 64
    before = pack_strands.launches
    got = pack_strands(raw, 0, start, length, fwd, width)  # CPU: plain
    assert pack_strands.launches == before
    np.testing.assert_array_equal(got.numpy(), padded(rows, width))
    # a sub-range of the bytes: starts relative to its first byte, and a
    # width that is not a multiple of 16
    lo = 20
    base = int(start[2 * lo if do_rc else lo])
    part = slice(2 * lo if do_rc else lo, None)
    got = pack_strands_ref(raw[base:], base, start[part], length[part],
                           fwd[part], width + 5)
    np.testing.assert_array_equal(got.numpy(),
                                  padded(rows[part], width + 5))


@pytest.mark.parametrize("filtered", [False, True],
                         ids=["unfiltered", "filtered"])
@pytest.mark.parametrize("do_rc", [True, False], ids=["rc", "fwd_only"])
def test_store_equal_the_host_route(do_rc, filtered):
    reads = seeded_reads(2)
    headers = [f"read{i}" for i in range(len(reads))]
    vf = kmer_filter(reads) if filtered else None
    ov = overlapper(vf)
    got_chunks = spy_chunks(ov)
    got = ov.sketch_reads(reads, headers, offset=7, do_rc=do_rc)
    want_ov = overlapper(vf)
    want_chunks = spy_chunks(want_ov)
    want = host_route(want_ov, reads, headers, offset=7, do_rc=do_rc)
    assert_same_store(got, want)
    # the same chunks, row for row, with chunks that end between a read's
    # two strands and one of a single row
    assert len(got_chunks) == len(want_chunks)
    for (gc, gl), (wc, wl) in zip(got_chunks, want_chunks):
        assert torch.equal(gc, wc) and torch.equal(gl, wl)
    sizes = np.cumsum([len(c) for c, _ in got_chunks])
    if do_rc:
        assert (sizes % 2 == 1).any()
    assert [len(c) for c, w in got_chunks if w.max() == 2000] == \
        [1] * (2 if do_rc else 1)
    # dropped: reads under --min-olap-length, and kept reads under k,
    # which have no k-mer
    assert min(got.length) >= 16
    assert len(set(got.header_id)) < sum(len(r) >= CFG["min_olap_length"]
                                         for r in reads)


def test_store_without_headers_or_reads():
    reads = seeded_reads(3)
    ov = overlapper()
    assert_same_store(ov.sketch_reads(reads), host_route(ov, reads))
    empty = ov.sketch_reads([])
    assert len(empty) == 0 and empty.minhash.shape == (0, 64)
    short = ov.sketch_reads(["ACGT", "acgtacgtac"])  # one kept, no k-mer
    assert len(short) == 0 and short.headers == []


def test_reads_outside_ascii_upper_case_on_the_host_as_before():
    """'ı' and 'ſ' upper-case to 'I' and 'S', 'ß' to 'SS' (the read grows
    and sorts by its new length); a character with no ASCII upper case
    raises UnicodeEncodeError as the host route's encode did, unless its
    read is dropped first."""
    reads = seeded_reads(4, n=24) + ["acgtı" * 30, "ſACGT" * 30,
                                     "ACGTß" * 30, "é" * 5]
    ov = overlapper()
    trace.enable()
    try:
        with trace.span("job"):
            got = ov.sketch_reads(reads)
        job, = trace.jobs()
    finally:
        trace.disable()
        trace.reset()
    assert_same_store(got, host_route(ov, reads))
    assert job.counters["sketch_reads_upper_host"] == 3
    assert 180 in got.length  # 'ACGTß' * 30 upper-cased
    bad = reads + ["ACGTé" * 30]
    with pytest.raises(UnicodeEncodeError) as want:
        host_route(ov, bad)
    with pytest.raises(UnicodeEncodeError) as got_err:
        ov.sketch_reads(bad)
    assert str(got_err.value) == str(want.value)


@pytest.mark.parametrize("rows", [ROWS, 8], ids=["odd_rows", "even_rows"])
def test_upload_counter(rows):
    """``sketch_upload_bytes``: each chunk's reads' bytes, so the kept
    reads' bases plus, for each chunk that ends between a read's two
    strands, that read's bases again."""
    reads = seeded_reads(5)
    ov = overlapper(rows=rows, cells=1 << 20)
    chunks = spy_chunks(ov)
    trace.enable()
    try:
        with trace.span("job"):
            ov.sketch_reads(reads)
        job, = trace.jobs()
    finally:
        trace.disable()
        trace.reset()
    kept = sum(len(r) for r in reads if len(r) >= CFG["min_olap_length"])
    split = sum(int(lens[-1]) for (_c, lens), end in zip(
        chunks, np.cumsum([len(c) for c, _ in chunks])) if end % 2)
    assert job.counters["sketch_upload_bytes"] == kept + split
    assert (split > 0) == (rows % 2 == 1)
    assert job.counters["sketch_reads_upper_host"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("source, width_extra",
                         [("seeded", 0), ("seeded", 5), ("primary", 0)],
                         ids=["vector_stores", "byte_stores",
                              "primary_reads"])
def test_pack_kernel_bit_equal_on_the_card(source, width_extra):
    """Seeded reads, and the main path's shape: bench.py's 1,024 primary
    reads, every third lower case (rows [2,039, 2,944])."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    if source == "seeded":
        reads = seeded_reads(6, n=400)
    else:
        import bench

        reads = [r.lower() if i % 3 == 0 else r
                 for i, r in enumerate(bench.make_reads())]
    (raw, start, length, fwd), rows = strand_rows(reads, True)
    # every byte value once, both strands, after the reads
    every = torch.arange(256, dtype=torch.uint8)
    raw = torch.cat([raw, every])
    start = torch.cat([start, torch.tensor([len(raw) - 256] * 2)])
    length = torch.cat([length, torch.tensor([256, 256])])
    fwd = torch.cat([fwd, torch.tensor([1, 0])])
    width = -(-int(length.max()) // 64) * 64 + width_extra
    lo = 11  # from a read's reverse strand on, as a chunk may start
    base = int(start[lo])
    want = pack_strands_ref(raw[base:], base, start[lo:], length[lo:],
                            fwd[lo:], width)
    dev = torch.device("cuda")
    before = pack_strands.launches
    got = pack_strands(raw[base:].to(dev), base, start[lo:].to(dev),
                       length[lo:].to(dev), fwd[lo:].to(dev), width)
    torch.cuda.synchronize()
    assert pack_strands.launches == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_store_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    reads = seeded_reads(7)
    want = overlapper().sketch_reads(reads)
    ov = TorchOverlapper(CFG, device="cuda")
    ov.ROWS, ov.CELLS = ROWS, CELLS
    got = ov.sketch_reads(reads)
    for name in ("header_id", "is_fwd", "length"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    for name in COLS:
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
