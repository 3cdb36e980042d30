"""tf-idf / legacy k-mer weights on the device (counterpart of
mhap_tpu/pipeline/freqfilter.py ``VectorFrequencyFilter``).

The file k-mers of a filter (io/filter.py) live on the device as a sorted
int64 key tensor and a float64 scaled-idf tensor with one trailing miss
row that carries ``range``.  A k-mer is looked up with
``torch.searchsorted``; the weight of a (k-mer, occurrence count) follows
MinHashSketch.java:95-128:

  * legacy (repeat_weight < 0): 1, or 0 for a file k-mer;
  * tf-idf (0 <= repeat_weight < 1): max(1, floor(tf * sidf + 0.5)) in
    float64, tf = count (1 under --no-tf);
  * repeat_weight >= 1: the count (the overlapper runs its plain path).

``--supress-noise`` 1 and 2 add the set of every file line's k-mer: a
sorted key tensor (``searchsorted``) or the Guava bloom filter, whose
words live on the device and whose probes are gathers (io/filter.py).
Under mode 1 a k-mer outside the set is not a k-mer at all (keepKmer):
the overlapper drops it, by ``member``, before counting.  Under mode 2
its scaled idf is 1.0 (FrequencyCounts.java scaledIdf).

The product and the ``+ 0.5`` are two eager float64 tensor ops, each
rounded once as Java's double multiply and add are; a fused multiply-add
would change some weights by 1.
"""

from __future__ import annotations

import torch

from ..device import resolve_device
from ..io.filter import GuavaBloomFilter
from ..utils import trace

_I32_MAX = (1 << 31) - 1


class VectorFrequencyFilter:
    def __init__(self, fc, device="cuda"):
        dev = resolve_device(device)
        self.no_tf = fc.no_tf
        self.remove_unique = fc.remove_unique
        sidf = torch.cat([fc.sidf, torch.tensor([float(fc.range)],
                                                dtype=torch.float64)])
        with trace.span("load.wait"):  # the filter's copies to the device
            self.valid = None if fc.valid is None else fc.valid.to(dev)
            self.keys = fc.keys.to(dev)
            self.sidf = sidf.to(dev)

    @property
    def device(self) -> torch.device:
        return self.keys.device

    def member(self, keys: torch.Tensor) -> torch.Tensor:
        """Is each key a k-mer line of the file (bloom: might it be)?"""
        if isinstance(self.valid, GuavaBloomFilter):
            return self.valid.contains(keys)
        K = self.valid.numel()
        if K == 0:
            return torch.zeros(keys.shape, dtype=torch.bool,
                               device=keys.device)
        i = torch.searchsorted(self.valid, keys).clamp_(max=K - 1)
        return self.valid[i] == keys

    def _index(self, keys: torch.Tensor) -> torch.Tensor:
        """Row of each key in the file table, or K (the miss row)."""
        K = self.keys.numel()
        if K == 0:
            return torch.zeros_like(keys)
        i = torch.searchsorted(self.keys, keys).clamp_(max=K - 1)
        return torch.where(self.keys[i] == keys, i, K)

    def weights(self, keys: torch.Tensor, counts: torch.Tensor,
                repeat_weight: float) -> torch.Tensor:
        """int32 weight of each (key, count), keys int64 and counts
        integer tensors of one shape on the filter's device."""
        if repeat_weight < 0.0:
            popular = self._index(keys) < self.keys.numel()
            return torch.where(popular, 0, 1).to(torch.int32)
        if repeat_weight < 1.0:
            sidf = self.sidf[self._index(keys)]
            if self.remove_unique == 2:
                sidf = torch.where(self.member(keys), sidf, 1.0)
            prod = sidf if self.no_tf else counts.to(torch.float64) * sidf
            w = torch.floor(prod + 0.5)
            return w.clamp_(1, _I32_MAX).to(torch.int32)
        return counts.to(torch.int32)
