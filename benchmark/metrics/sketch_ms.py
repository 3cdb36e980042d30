"""Milliseconds a job spends sketching reads:
`TorchOverlapper.sketch_reads` (host preparation, `ops/murmur3`, kernels
1 and 2 through `ops/minhash`, `ops/bottomk`, `pipeline/freqfilter`).
"""

SPANS = ["mhap_tpu_torch.pipeline.overlapper:TorchOverlapper.sketch_reads"]


def read(run):
    return run.span_ms(SPANS)
