"""The port's hand-written CUDA kernels (``csrc/``), their wrappers and
their plain PyTorch versions (counterpart of ``repro.kernels``)."""
