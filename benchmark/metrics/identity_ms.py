"""Milliseconds a job spends on the host's float64 identities of scored
pairs (`TorchOverlapper._identity_scores`).
"""

SPANS = ["mhap_tpu_torch.pipeline.overlapper:TorchOverlapper._identity_scores"]


def read(run):
    return run.span_ms(SPANS)
