"""The benchmark of the PyTorch and CUDA port, fdoct_tpu_torch (see README.md)."""
