"""The benchmark of the PyTorch and CUDA port (`mhap_tpu_torch`); see run.py."""
