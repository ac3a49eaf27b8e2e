"""Hand-written Hopper kernels of the port, each in the reference's
``<kernel>/ops.py`` (dispatcher) + ``ref.py`` (plain PyTorch version)
layout; the CUDA sources live in ``repro_torch/csrc``."""
