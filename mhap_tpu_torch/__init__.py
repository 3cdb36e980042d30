"""PyTorch + CUDA port of the mhap_tpu self-overlap path.

Plain functions on tensors with an explicit ``device`` argument.  The
hot loops (weighted-MinHash min-reduce, pair scorer) are CUDA kernels
for Hopper (``csrc/``), built on first use; every kernel has a plain
PyTorch version beside it that runs for CPU tensors.
"""
