"""Milliseconds a job spends parsing `.dat` sketch files: the record by
record parse of a file's bytes into the store's host columns
(`io/datstore.parse_dat`), for the store block and each query block,
without the file's read and the copies to the card.
"""

SPANS = ["mhap_tpu_torch.io.datstore:parse_dat"]


def read(run):
    return run.span_ms(SPANS)
