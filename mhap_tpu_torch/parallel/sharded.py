"""Multi-GPU overlapper over ``torch.distributed`` ranks (counterpart of
mhap_tpu/parallel/sharded.py, ``ShardedOverlapper``).

Rank r of D runs on its own device and every rank makes the same
sequence of collective calls (``parallel/comm.py``):

  * sketch, row-sharded: rank r sketches reads [r n/D, (r+1) n/D) with
    their global ids, both strands of a read on one rank (the zero-ngram
    rule pairs them by adjacency); the host metadata of every row
    (header id, strand, length, headers when any) is all-gathered, the
    sketch columns stay on their owner.  A store row's global id is its
    rank's row offset plus its local index.
  * index, band-sharded: one all_to_all of the [n_r, H] MinHash rows
    gives rank d every row's values in bands [d H/D, (d+1) H/D), and
    ``index/postings.build_postings`` sorts them into postings whose
    sids are global rows.
  * vote, hits routed to each query's owner: every band owner finds each
    query's spans in its bands (searchsorted); the hits per query, summed
    over ranks, cut the same query chunks on every rank under
    ``postings.HIT_BUDGET``; in each chunk each band owner expands its
    hits and sends the ``q * N + cand`` keys to the query's owner, which
    counts the votes over every band and keeps ``num_min_matches``.
    The suppression rules then run at the owner on the global metadata.
  * score: the owner fetches the distinct candidate rows it does not
    hold from their owners (ids out, ordered sketch rows back), one
    all_to_all pair a ``SCORE_CHUNK`` of pairs, every rank running the
    largest count of chunks; kernel 3 scores them locally.
  * identity and M4 lines at the owner; the lines are gathered to rank 0,
    which returns the sorted set (the other ranks return []).

The line set is the single-GPU ``TorchOverlapper``'s at every D, and the
stats summed over ranks (``total_stats``) are its stats.  Memory per rank
is O(N/D S + N H/D + chunk).  Not ported: the JAX package's wide vote
under the mesh (the vote here is exact at every size) and its
capacity ladder, padding rows and sentinels, the psum row gather that
replicates [T, C] rows on every device, and its multi-controller mode
(one process a card is torch's only mode).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..index import postings as _postings
from ..io.formats import M4Lines
from ..ops.scorer_kernels import score_pairs as _score_pairs_kernel
from ..pipeline.overlapper import SketchStore, TorchOverlapper, score_columns

_INT_STATS = ("matches_processed", "sequences_searched",
              "elements_processed", "sequences_hit",
              "sequences_fully_compared")


class ShardedStore(SketchStore):
    """A store split by rows over the ranks: the host metadata
    (``header_id``, ``is_fwd``, ``length``, ``headers``) of every row, by
    global row; the device columns of rows ``[lo, hi)`` only, this
    rank's.  ``offsets`` [D + 1] are every rank's first row."""

    def __init__(self, local: SketchStore, header_id, is_fwd, length,
                 headers, offsets, rank: int):
        super().__init__(header_id, is_fwd, length, *local_cols(local),
                         headers=headers)
        self.offsets = np.asarray(offsets, np.int64)
        self.lo, self.hi = int(offsets[rank]), int(offsets[rank + 1])

    def owner(self, rows: np.ndarray) -> np.ndarray:
        """The rank that holds each global row."""
        return np.searchsorted(self.offsets, rows, side="right") - 1


def local_cols(store: SketchStore):
    return (store.minhash, store.ordered_h, store.ordered_p,
            store.ordered_m, store.num_kmers)


class ShardedOverlapper(TorchOverlapper):
    """``TorchOverlapper`` over the ranks of ``comm`` (a
    ``parallel.comm.Comm``), each on ``comm.device``.  ``kmer_filter`` is
    this rank's ``VectorFrequencyFilter`` on that device."""

    def __init__(self, comm, cfg=None, kmer_filter=None):
        super().__init__(cfg, comm.device, kmer_filter)
        self.comm = comm
        if self.cfg["num_hashes"] % comm.world:
            raise ValueError(
                f"num_hashes={self.cfg['num_hashes']} must be divisible by "
                f"the world size {comm.world}")
        self.index_bytes = 0  # this rank's postings, last index built

    # ---------------- sketch ----------------

    def _range(self, n: int):
        r, D = self.comm.rank, self.comm.world
        return r * n // D, (r + 1) * n // D

    def sketch_reads(self, reads, headers=None, offset: int = 0,
                     do_rc: bool = True) -> ShardedStore:
        lo, hi = self._range(len(reads))
        local = super().sketch_reads(
            reads[lo:hi], None if headers is None else headers[lo:hi],
            offset + lo, do_rc)
        c = self.comm
        meta = torch.from_numpy(np.stack(
            [local.header_id, local.is_fwd.astype(np.int64),
             local.length.astype(np.int64)], axis=1))
        parts = c.all_gather(meta)
        meta = torch.cat(parts).numpy()
        hdrs = None
        if c.max_int(int(any(h is not None for h in local.headers))):
            hdrs = [h for blob in c.all_gather_bytes(
                json.dumps(local.headers).encode())
                for h in json.loads(blob)]
        return ShardedStore(local, meta[:, 0], meta[:, 1].astype(bool),
                            meta[:, 2].astype(np.int32), hdrs,
                            np.cumsum([0] + [len(p) for p in parts]),
                            c.rank)

    def read_dat(self, path: str, offset: int = 0,
                 fwd_only: bool = False) -> ShardedStore:
        """Every rank reads the file and keeps the rows of its range of
        reads (a read's rows are consecutive and share a header id)."""
        from ..io import datstore

        whole = datstore.read_dat(path, offset, fwd_only,
                                  self.cfg["ordered_sketch_size"], "cpu")
        hid = whole.header_id
        starts = np.r_[np.flatnonzero(np.diff(hid, prepend=-1)), len(hid)]
        n, D = len(starts) - 1, self.comm.world
        offsets = starts[[d * n // D for d in range(D + 1)]]
        lo, hi = offsets[self.comm.rank], offsets[self.comm.rank + 1]
        local = SketchStore(
            hid[lo:hi], whole.is_fwd[lo:hi], whole.length[lo:hi],
            *(col[lo:hi].to(self.device) for col in local_cols(whole)))
        return ShardedStore(local, hid, whole.is_fwd, whole.length,
                            whole.headers, offsets, self.comm.rank)

    def whole_store(self, store: ShardedStore):
        """The store with every rank's rows, on the host of rank 0 (None
        on the other ranks)."""
        parts = [self.comm.gather(col) for col in local_cols(store)]
        if parts[0] is None:
            return None
        return SketchStore(store.header_id, store.is_fwd, store.length,
                           *(torch.cat(p).cpu() for p in parts),
                           headers=store.headers)

    # ---------------- index + vote ----------------

    def _bands(self, store: ShardedStore) -> torch.Tensor:
        """[N, H/D]: every row's MinHash values in this rank's bands."""
        D = self.comm.world
        mh = store.minhash
        n, H = mh.shape
        send = mh.reshape(n, D, H // D).transpose(0, 1).reshape(-1, H // D)
        return self.comm.all_to_all_v(send, [n] * D)[0]

    def _build_index(self, store: ShardedStore):
        band = self._bands(store)
        vals, sids = _postings.build_postings(band)
        self.index_bytes = vals.nbytes + sids.nbytes
        return vals, sids, band, store

    def _vote(self, index, queries: ShardedStore, q_sel: np.ndarray):
        """Every rank passes the same ``q_sel`` and gets the pairs of the
        queries it owns."""
        vals, sids, band, store = index
        c, dev = self.comm, self.device
        N = vals.shape[1]
        qband = band if queries is store else self._bands(queries)
        qT = qband[torch.from_numpy(q_sel).to(dev)].t().contiguous()
        owner = queries.owner(q_sel)
        self.stats["sequences_searched"] += int(np.sum(owner == c.rank))
        owner = torch.from_numpy(owner).to(dev)
        left = torch.searchsorted(vals, qT)
        cnt = torch.searchsorted(vals, qT, right=True) - left
        per_q = c.all_reduce(cnt.sum(0)).tolist()  # over every band
        hits, distinct = 0, 0
        outs = [torch.zeros(0, dtype=torch.int64, device=dev)]
        for s, e in _postings.chunk_bounds(per_q):
            q, cand = _postings.expand_hits(sids, left[:, s:e],
                                            cnt[:, s:e], s)
            hits += q.numel()
            dest = owner[q]
            order = torch.argsort(dest, stable=True)
            keys, _ = c.all_to_all_v(
                (q * N + cand)[order],
                torch.bincount(dest, minlength=c.world).tolist())
            kept, n = _postings.count_votes(keys, self.cfg["num_min_matches"])
            distinct += n
            outs.append(kept)
        self.stats["elements_processed"] += hits
        self.stats["sequences_hit"] += distinct
        key = torch.cat(outs).cpu().numpy()
        return key // N, key % N

    # ---------------- scoring ----------------

    def _fetch_rows(self, cs: ShardedStore, rows: np.ndarray):
        """Ordered-sketch columns of the distinct store ``rows`` (this
        rank's own, then those fetched from their owners) and each row's
        index into them."""
        c, dev = self.comm, self.device
        S = self.cfg["ordered_sketch_size"]
        uniq, inv = np.unique(rows.astype(np.int64), return_inverse=True)
        owner = cs.owner(uniq)
        mine = owner == c.rank
        remote = uniq[~mine]  # ascending, so grouped by owner
        asked, asked_splits = c.all_to_all_v(
            torch.from_numpy(remote).to(dev),
            np.bincount(owner[~mine], minlength=c.world))
        r = asked - cs.lo
        packed = torch.cat([cs.ordered_h[r], cs.ordered_p[r],
                            cs.ordered_m[r][:, None],
                            cs.num_kmers[r][:, None]], dim=1)
        got, _ = c.all_to_all_v(packed, asked_splits)
        m = torch.from_numpy(uniq[mine] - cs.lo).to(dev)
        cols = tuple(torch.cat([a, b]).contiguous() for a, b in (
            (cs.ordered_h[m], got[:, :S]), (cs.ordered_p[m], got[:, S:2 * S]),
            (cs.ordered_m[m], got[:, 2 * S]),
            (cs.num_kmers[m], got[:, 2 * S + 1])))
        pos = np.empty(len(uniq), np.int64)
        pos[mine] = np.arange(int(mine.sum()))
        pos[~mine] = int(mine.sum()) + np.arange(len(remote))
        return cols, pos[inv]

    def _score_dispatch(self, qs: ShardedStore, cs: ShardedStore,
                        qi: np.ndarray, ci: np.ndarray) -> dict:
        """Kernel 3 over this rank's pairs (its queries), chunked; every
        rank runs the largest count of chunks, fetching rows in each."""
        dev, step = self.device, self.SCORE_CHUNK
        parts = []
        for s in range(0, self.comm.max_int(len(qi)), step):
            c_cols, c_idx = self._fetch_rows(cs, ci[s:s + step])
            if len(c_idx):
                q = torch.from_numpy(qi[s:s + step] - qs.lo).to(dev)
                parts.append(_score_pairs_kernel(
                    qs.scorer_cols(), c_cols, q,
                    torch.from_numpy(c_idx).to(dev),
                    float(self.cfg["max_shift"])).cpu().numpy())
        return score_columns(parts)

    # ---------------- results ----------------

    def _gather_lines(self, lines) -> M4Lines:
        """Every rank's lines, sorted on rank 0 (empty elsewhere)."""
        blobs = self.comm.gather_bytes(M4Lines.of(lines).data.tobytes())
        if blobs is None:
            return M4Lines()
        data = np.frombuffer(b"".join(blobs), np.uint8)
        return M4Lines(data, int(np.count_nonzero(data == 10))).sorted()

    def total_stats(self) -> dict:
        """Integer stats summed over ranks, times the largest rank's."""
        c = self.comm
        ints = c.all_reduce(torch.tensor([self.stats[k] for k in _INT_STATS],
                                         dtype=torch.int64))
        times = [k for k in self.stats if k not in _INT_STATS]
        secs = c.all_reduce(torch.tensor([self.stats[k] for k in times],
                                         dtype=torch.float64),
                            torch.distributed.ReduceOp.MAX)
        return {**dict(zip(_INT_STATS, ints.tolist())),
                **dict(zip(times, secs.tolist()))}

