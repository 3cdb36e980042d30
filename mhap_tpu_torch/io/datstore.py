"""Sketch stores on disk (counterpart of mhap_tpu/io/datstore.py).

1. The reference's ``.dat`` binary format (its checkpoint of ``-p``):
   record = [u8 isFwd][i32be byteLen][payload], payload (big-endian, Java
   DataOutputStream) = u8 isFwd, i64 headerId, UTF header (u16 len +
   modified-UTF8), i32 seqLen, MinHash (i32 n + n * i32)
   (MinHashSketch.java:218-230), Bottom (i32 numKmers, i32 kmerSize,
   i32 m + m * (i32 hash, i32 pos)) (BottomOverlapSketch.java:561-585);
   framing as SequenceSketchStreamer.writeToBinary:322-395 and
   readFromBinary:278-320.  The files are byte-equal to the JAX
   package's.
2. A columnar ``.npz``: the store's arrays as they are, one file a store.

Both read into the port's ``SketchStore``, its sketch columns on the
device given.  A ``.dat`` record keeps its header string from write time
(the read's number when it had no header), so queries read from ``.dat``
print the ids they had at ``-p`` time, whatever offset they are read at.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..device import resolve_device
from ..ops.bottomk import PAD_HASH, PAD_POS
from ..pipeline.overlapper import SketchStore
from ..utils import trace


def _write_utf(s: str) -> bytes:
    b = s.encode("utf-8")  # ASCII headers: modified-UTF8 == UTF-8
    if len(b) > 0xFFFF:
        raise ValueError("header too long for Java writeUTF")
    return struct.pack(">H", len(b)) + b


def write_dat(path: str, store: SketchStore, fwd_only: bool = False,
              ordered_kmer_size: int = 12) -> int:
    """Writes every row of ``store`` (its forward rows with fwd_only),
    skipping padding rows of header id 0; returns the records written."""
    with trace.span("dat.wait"):
        mh = store.host("minhash").astype(">i4")
        oh = store.host("ordered_h")
        op = store.host("ordered_p")
        om = store.host("ordered_m")
        nk = store.host("num_kmers")
    written = 0
    with open(path, "wb") as f:
        for i in range(len(store)):
            fwd = bool(store.is_fwd[i])
            if fwd_only and not fwd:
                continue
            hid = int(store.header_id[i])
            if hid == 0:
                continue
            header = store.headers[i]
            if header is None:
                header = str(hid)
            m = int(om[i])
            pairs = np.empty((m, 2), dtype=">i4")
            pairs[:, 0] = oh[i, :m]
            pairs[:, 1] = op[i, :m]
            payload = b"".join((
                struct.pack(">Bq", 1 if fwd else 0, hid), _write_utf(header),
                struct.pack(">ii", int(store.length[i]), mh.shape[1]),
                mh[i].tobytes(),
                struct.pack(">iii", int(nk[i]), ordered_kmer_size, m),
                pairs.tobytes()))
            f.write(struct.pack(">Bi", 1 if fwd else 0, len(payload)))
            f.write(payload)
            written += 1
    return written


def parse_dat(data: bytes, offset: int = 0, fwd_only: bool = False,
              sketch_size: int = 1536) -> dict:
    """The records of a ``.dat`` file's bytes as host columns, under the
    names of ``SketchStore``'s arguments: header ids shifted by
    ``offset``, ordered sketches padded with the scorer's sentinels (or
    cut) to ``sketch_size`` entries."""
    recs = []
    pos, n = 0, len(data)
    while pos + 5 <= n:
        is_fwd_tag, blen = struct.unpack_from(">Bi", data, pos)
        pos += 5
        if pos + blen > n:
            break
        payload = memoryview(data)[pos:pos + blen]
        pos += blen
        if fwd_only and is_fwd_tag != 1:
            continue
        fwd, hid, hl = struct.unpack_from(">BqH", payload, 0)
        p = 11
        header = bytes(payload[p:p + hl]).decode("utf-8")
        p += hl
        seq_len, nmh = struct.unpack_from(">ii", payload, p)
        p += 8
        mh = np.frombuffer(payload, dtype=">i4", count=nmh, offset=p)
        p += 4 * nmh
        nk, _k2, m = struct.unpack_from(">iii", payload, p)
        p += 12
        pairs = np.frombuffer(payload, dtype=">i4", count=2 * m,
                              offset=p).reshape(m, 2)
        recs.append((hid + offset, fwd != 0, header, seq_len, mh, nk,
                     pairs[:sketch_size]))
    N = len(recs)
    H = len(recs[0][4]) if N else 0
    S = sketch_size
    oh = np.full((N, S), PAD_HASH, np.int32)
    op = np.full((N, S), PAD_POS, np.int32)
    om = np.zeros(N, np.int32)
    for i, r in enumerate(recs):
        m = len(r[6])
        oh[i, :m], op[i, :m], om[i] = r[6][:, 0], r[6][:, 1], m
    mh = (np.stack([r[4] for r in recs]).astype(np.int32) if N
          else np.zeros((0, H), np.int32))
    return dict(
        header_id=np.asarray([r[0] for r in recs], np.int64),
        is_fwd=np.asarray([r[1] for r in recs], bool),
        length=np.asarray([r[3] for r in recs], np.int32),
        minhash=mh, ordered_h=oh, ordered_p=op, ordered_m=om,
        num_kmers=np.asarray([r[5] for r in recs], np.int32),
        headers=[r[2] for r in recs])


# the columns of a store that live on its device
_DEVICE_COLS = ("minhash", "ordered_h", "ordered_p", "ordered_m",
                "num_kmers")


def read_dat(path: str, offset: int = 0, fwd_only: bool = False,
             sketch_size: int = 1536, device="cuda") -> SketchStore:
    """A ``.dat`` file as a dense store (``parse_dat``), its sketch
    columns copied to ``device``."""
    with open(path, "rb") as f:
        data = f.read()
    with trace.span("dat.parse"):
        cols = parse_dat(data, offset, fwd_only, sketch_size)
    trace.count("dat_records", len(cols["header_id"]))
    trace.count("dat_bytes", len(data))
    dev = resolve_device(device)
    with trace.span("load.wait"):
        for name in _DEVICE_COLS:
            cols[name] = torch.from_numpy(cols[name]).to(dev)
    return SketchStore(**cols)


def write_npz(path: str, store: SketchStore) -> None:
    """The store's columns, compressed, in one ``.npz``."""
    np.savez_compressed(
        path, header_id=store.header_id, is_fwd=store.is_fwd,
        length=store.length, minhash=store.host("minhash"),
        ordered_h=store.host("ordered_h"), ordered_p=store.host("ordered_p"),
        ordered_m=store.host("ordered_m"), num_kmers=store.host("num_kmers"),
        headers=np.asarray([h if h is not None else ""
                            for h in store.headers]),
        has_header=np.asarray([h is not None for h in store.headers]))


def read_npz(path: str, device="cuda") -> SketchStore:
    z = np.load(path, allow_pickle=False)
    dev = resolve_device(device)

    def col(name):
        return torch.from_numpy(z[name].astype(np.int32)).to(dev)

    return SketchStore(
        header_id=z["header_id"], is_fwd=z["is_fwd"], length=z["length"],
        minhash=col("minhash"), ordered_h=col("ordered_h"),
        ordered_p=col("ordered_p"), ordered_m=col("ordered_m"),
        num_kmers=col("num_kmers"),
        headers=[str(h) if b else None
                 for h, b in zip(z["headers"], z["has_header"])])
