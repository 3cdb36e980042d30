"""Milliseconds a job spends loading its input: FASTA reads
(`cli/options._load_reads` as `cli/main.py` calls it, `io/fasta`),
`.dat` sketch files (`io/datstore` through `TorchOverlapper.read_dat`)
and the filter file (`cli/main.load_filter`, `io/filter`).
"""

SPANS = ["mhap_tpu_torch.cli.main:_load_reads",
         "mhap_tpu_torch.pipeline.overlapper:TorchOverlapper.read_dat",
         "mhap_tpu_torch.cli.main:load_filter"]


def read(run):
    return run.span_ms(SPANS)
