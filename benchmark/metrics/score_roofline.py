"""Kernel 3 (``csrc/scorer.cu``) as a share of its roofline: the least
time the card needs for the pairs handed to ``_score_dispatch`` in the
profiled jobs, over the device time of the kernel.

Work (frozen from ``chip_smoke.k3_timing``): each distinct store row the
pairs gather is read once, its real (hash, position) entries at 8 bytes
and two counts; each pair reads two indices and writes 16 int32 columns;
two merge passes step a cursor over both rows' real entries, about 8
INT32 operations a step.
"""

import torch

from benchmark.peaks import bound_s

SPAN = "mhap_tpu_torch.pipeline.overlapper:TorchOverlapper._score_dispatch"
SPANS = [SPAN]
KEEP = [SPAN]
KERNELS = ["score_pairs_kernel", "score_pairs_wide_kernel"]


def work(calls):
    """(bytes, INT32 operations) over the kept calls of
    ``_score_dispatch(self, qs, cs, qi, ci)``."""
    nbytes = nops = 0
    for args, _kwargs in calls:
        _ov, qs, cs, qi, ci = args[:5]
        dev = qs.ordered_m.device
        qm, cm = qs.ordered_m.long(), cs.ordered_m.long()
        q = torch.from_numpy(qi).to(dev).long()
        c = torch.from_numpy(ci).to(dev).long()
        m_sum = int(qm[q].sum() + cm[c].sum())
        if qs is cs:
            groups = ((qm, torch.unique(torch.cat([q, c]))),)
        else:
            groups = ((qm, torch.unique(q)), (cm, torch.unique(c)))
        row_bytes = sum(int(m[d].sum()) * 8 + len(d) * 8 for m, d in groups)
        nbytes += row_bytes + len(qi) * (2 * 4 + 16 * 4)
        nops += 2 * m_sum * 8
    return nbytes, nops


def read(run):
    if run.trace is None:
        return None
    t = run.trace.kernel_seconds(KERNELS)
    calls = run.kept(SPAN)
    if not t or not calls:
        return None
    w = work(calls)
    b = bound_s(run.card, *w) if w[1] else None
    return None if b is None else 100.0 * b / t
