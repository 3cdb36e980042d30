"""Kernels 1 and 2 (``csrc/minhash.cu``) as a share of their roofline:
the least time the card needs for the MinHash of the profiled jobs'
sketched reads, over the device time of those kernels.

Work, from the reads each ``sketch_reads`` call was handed (frozen from
``chip_smoke.py``'s kernel 1 and 2 bounds): each valid 16-mer of each
sketched strand is read once, 9 bytes (its hash and its valid flag), and
steps its xorshift stream once a slot, 16 INT32 operations a step
(``OPS_PER_STREAM_STEP``); each row writes H int32 slots.  Without a
filter file a k-mer's weight is its count in the read, so the steps of a
read's distinct k-mers sum to its k-mers.
"""

from benchmark.peaks import bound_s

SPAN = "mhap_tpu_torch.pipeline.overlapper:TorchOverlapper.sketch_reads"
SPANS = [SPAN]
KEEP = [SPAN]
KERNELS = ["min_reduce_kernel", "min_reduce_light_kernel",
           "min_reduce_heavy_kernel", "min_reduce_fold_kernel"]
OPS_PER_STREAM_STEP = 16


def work(calls):
    """(bytes, INT32 operations) of the kernels over the kept calls of
    ``sketch_reads(self, reads, headers=None, offset=0, do_rc=True)``."""
    nbytes = nops = 0
    for args, kwargs in calls:
        ov, reads = args[0], args[1]
        do_rc = kwargs.get("do_rc", args[4] if len(args) > 4 else True)
        if ov.kmer_filter is not None:
            return None  # filter weights: not this bound's count
        k, H = ov.cfg["kmer_size"], ov.cfg["num_hashes"]
        strands = 2 if do_rc else 1
        lens = [len(r) for r in reads if len(r) >= ov.cfg["min_olap_length"]]
        kmers = sum(n - k + 1 for n in lens if n >= k) * strands
        nbytes += kmers * 9 + len(lens) * strands * H * 4
        nops += kmers * H * OPS_PER_STREAM_STEP
    return nbytes, nops


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_seconds(KERNELS)
    w = work(run.kept(SPAN))
    if not t or not w or not w[1]:
        return None
    b = bound_s(run.card, *w)
    return None if b is None else 100.0 * b / t
