"""Hand-written CUDA kernels (``csrc/``), their ctypes wrappers and their
plain PyTorch versions (``ref``)."""
