"""Milliseconds a job spends in the vote: the sorted postings
(`index/postings` through `TorchOverlapper._build_index`) and the
candidate pairs past the vote and the self rules
(`TorchOverlapper._candidates`).
"""

SPANS = ["mhap_tpu_torch.pipeline.overlapper:TorchOverlapper._build_index",
         "mhap_tpu_torch.pipeline.overlapper:TorchOverlapper._candidates"]


def read(run):
    return run.span_ms(SPANS)
