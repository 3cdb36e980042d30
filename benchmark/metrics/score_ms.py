"""Milliseconds a job spends scoring candidate pairs: kernel 3 through
`ops/scorer_kernels`, called by `TorchOverlapper._score_dispatch`, with
the copies of its columns back to the host.
"""

SPANS = ["mhap_tpu_torch.pipeline.overlapper:TorchOverlapper._score_dispatch"]


def read(run):
    return run.span_ms(SPANS)
