"""The port's ``.dat`` sketch files on the CPU against the JAX package:
files byte-equal to ``mhap_tpu.io.datstore.write_dat`` on the same
reads, ``read_dat`` columns equal (padding, clipping, offsets, forward
rows only), and the ``.npz`` round trip.  The CLI's ``.dat`` runs:
tests/test_torch_dat_cli.py."""

import numpy as np
import pytest
import torch

from mhap_tpu.io import datstore as jax_dat
from mhap_tpu.pipeline.overlapper import TpuOverlapper
from mhap_tpu_torch.io import datstore
from mhap_tpu_torch.pipeline.overlapper import TorchOverlapper

torch.set_num_threads(1)

CFG = dict(num_hashes=128, ordered_sketch_size=512, num_min_matches=2)
COLS = ("minhash", "ordered_h", "ordered_p", "ordered_m", "num_kmers")


@pytest.fixture(scope="module")
def reads(synthetic_reads):
    _genome, rs, _pos = synthetic_reads
    rs = list(rs[:12])
    rs[4] = rs[4][:200]  # 185 ordered k-mers: short of every sketch size
    return rs


@pytest.fixture(scope="module")
def stores(reads):
    """The same reads sketched by both packages, with headers."""
    heads = [f"r{i}" for i in range(len(reads))]
    jov = TpuOverlapper(CFG)
    jov.ROWS = 32  # its default tile pads these 24 rows to 512
    tov = TorchOverlapper(CFG, device="cpu")
    return ((jov.sketch_reads(reads, heads), tov.sketch_reads(reads, heads)),
            (jov.sketch_reads(reads), tov.sketch_reads(reads)))


@pytest.mark.parametrize("headers", [False, True])
@pytest.mark.parametrize("fwd_only", [False, True])
def test_write_dat_byte_equal(stores, tmp_path, headers, fwd_only):
    js, ts = stores[0] if headers else stores[1]
    jax_dat.write_dat(str(tmp_path / "j.dat"), js, fwd_only=fwd_only)
    datstore.write_dat(str(tmp_path / "t.dat"), ts, fwd_only=fwd_only)
    data = (tmp_path / "t.dat").read_bytes()
    assert data == (tmp_path / "j.dat").read_bytes() and len(data) > 1000


@pytest.mark.parametrize("S,offset,fwd_only", [(512, 0, False),
                                                (300, 7, True),
                                                (700, 3, False)])
def test_read_dat_columns(stores, tmp_path, S, offset, fwd_only):
    """Rows shorter than S are padded with the scorer's sentinels, longer
    ones cut; ids shifted by the offset, headers kept from write time."""
    js, _ts = stores[0]
    path = str(tmp_path / "x.dat")
    jax_dat.write_dat(path, js)
    want = jax_dat.read_dat(path, offset, fwd_only, sketch_size=S)
    got = datstore.read_dat(path, offset, fwd_only, sketch_size=S,
                            device="cpu")
    for name in ("header_id", "is_fwd", "length"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    for name in COLS:
        np.testing.assert_array_equal(got.host(name), getattr(want, name))
    assert got.headers == want.headers
    assert got.ordered_h.shape == (len(want.header_id), S)


def test_npz_roundtrip(stores, tmp_path):
    _js, ts = stores[0]
    path = str(tmp_path / "x.npz")
    datstore.write_npz(path, ts)
    got = datstore.read_npz(path, device="cpu")
    for name in ("header_id", "is_fwd", "length"):
        np.testing.assert_array_equal(getattr(got, name), getattr(ts, name))
    for name in COLS:
        np.testing.assert_array_equal(got.host(name), ts.host(name))
    assert got.headers == ts.headers
