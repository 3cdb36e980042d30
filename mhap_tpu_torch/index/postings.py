"""Exact LSH vote over sorted postings (counterpart of
mhap_tpu/index/postings.py and the host vote at
mhap_tpu/pipeline/overlapper.py:1339-1376).

MinHashSearch keeps one hash table per sketch slot (:85-147); a query
hits every stored sequence that shares its value in that slot, and a pair
becomes a candidate with at least ``num_min_matches`` hits (:161-225).
Here each slot's table is one sorted row of an [H, N] tensor: a batched
``searchsorted`` finds each query value's span, ``repeat_interleave``
expands the spans into hits, and a sort + ``unique_consecutive`` over
``q * N + cand`` keys counts the votes.  No span cap, no escalation
ladder: the hit expansion is chunked over queries to a fixed byte budget.
"""

from __future__ import annotations

import torch

from ..utils import trace

I64 = torch.int64
HIT_BUDGET = 1 << 25  # hits expanded at once (~1 GiB of int64 temporaries)


def build_postings(minhash: torch.Tensor):
    """[N, H] int32 sketches -> (vals [H, N] sorted per slot, sids [H, N]
    int64 store rows)."""
    vals, sids = torch.sort(minhash.t().contiguous(), dim=1, stable=True)
    return vals.contiguous(), sids


def expand_hits(sids, left, cnt, q0: int):
    """Hits of query columns with spans ``left``/``cnt`` [H, Qc] in the
    sorted postings (global query index q0 + column): (query, candidate)
    int64 pairs, one per hit."""
    N = sids.shape[1]
    Qc = left.shape[1]
    flat_cnt = cnt.reshape(-1)
    with trace.span("vote.wait"):  # the sizes come to the host
        nz = torch.nonzero(flat_cnt).squeeze(1)
        c = flat_cnt[nz]
        tot = int(c.sum())
    slot = nz // Qc
    start = slot * N + left.reshape(-1)[nz]
    run0 = torch.cumsum(c, 0) - c
    within = torch.arange(tot, device=sids.device) - \
        torch.repeat_interleave(run0, c, output_size=tot)
    pos = torch.repeat_interleave(start, c, output_size=tot) + within
    cand = sids.reshape(-1)[pos]
    q = torch.repeat_interleave(nz % Qc + q0, c, output_size=tot)
    return q, cand


def count_votes(keys: torch.Tensor, num_min_matches: int):
    """The distinct ``q * N + cand`` keys that occur at least
    num_min_matches times in ``keys``, sorted, and the number of distinct
    keys."""
    keys = torch.sort(keys).values
    with trace.span("vote.wait"):  # the sizes come to the host
        ukey, votes = torch.unique_consecutive(keys, return_counts=True)
        return ukey[votes >= num_min_matches], ukey.numel()


def chunk_bounds(per_q: list) -> list:
    """(start, end) of consecutive query chunks whose hits (``per_q``, a
    count a query) stay within HIT_BUDGET; a query with more hits than
    that is a chunk of its own."""
    bounds = [0]
    acc = 0
    for i, c in enumerate(per_q):
        if acc and acc + c > HIT_BUDGET:
            bounds.append(i)
            acc = 0
        acc += c
    bounds.append(len(per_q))
    return [(s, e) for s, e in zip(bounds[:-1], bounds[1:]) if e > s]


def vote(postings, query_mh: torch.Tensor, num_min_matches: int,
         chunks: list | None = None):
    """Candidate pairs of ``query_mh`` [Q, H] against the postings.

    Returns (q_idx, cand) int64 tensors over pairs with
    ``votes >= num_min_matches``, plus the search stats
    ``hits_total`` (every table element processed) and ``distinct``
    (distinct pairs before the threshold).  The hits are expanded in
    chunks of queries of at most HIT_BUDGET hits (``chunk_bounds``); each
    chunk's hits are appended to ``chunks`` when it is given."""
    vals, sids = postings
    H, N = vals.shape
    dev = vals.device
    qT = query_mh.t().contiguous()
    # each query value's span in its slot's table; the hits per query cut
    # the queries into chunks under the budget
    left = torch.searchsorted(vals, qT)
    cnt = torch.searchsorted(vals, qT, right=True) - left
    hits_total, distinct = 0, 0
    outs = []
    with trace.span("vote.wait"):
        per_q = cnt.sum(0).tolist()
    for s, e in chunk_bounds(per_q):
        q, cand = expand_hits(sids, left[:, s:e], cnt[:, s:e], s)
        hits_total += q.numel()
        if chunks is not None:
            chunks.append(q.numel())
        ukey, n = count_votes(q * N + cand, num_min_matches)
        distinct += n
        outs.append((ukey // N, ukey % N))
    if not outs:
        e = torch.zeros(0, dtype=I64, device=dev)
        return e, e, hits_total, distinct
    q_idx, cand = (torch.cat(x) for x in zip(*outs))
    return q_idx, cand, hits_total, distinct
