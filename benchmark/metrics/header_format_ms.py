"""Milliseconds a job spends formatting M4 lines whose reads carry header
strings (`.dat` records, `--store-full-id`): the Python %-format of
`TorchOverlapper._format_headers`, a part of what `format_ms` reads.
"""

SPANS = ["mhap_tpu_torch.pipeline.overlapper:"
         "TorchOverlapper._format_headers"]


def read(run):
    return run.span_ms(SPANS)
