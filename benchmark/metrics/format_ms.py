"""Milliseconds a job spends making and writing its M4 lines: coordinate
flips and formatting (`TorchOverlapper._format`, which calls
`utils/native.format_m4` on large batches), the sort of the lines
(`_gather_lines`) and their writing (`io/formats.write_lines` as
`cli/main.py` calls it).
"""

SPANS = ["mhap_tpu_torch.pipeline.overlapper:TorchOverlapper._format",
         "mhap_tpu_torch.pipeline.overlapper:TorchOverlapper._gather_lines",
         "mhap_tpu_torch.cli.main:write_lines"]


def read(run):
    return run.span_ms(SPANS)
