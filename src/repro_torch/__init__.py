"""PyTorch / CUDA port of the NDPP sampling system for one NVIDIA H100.

Mirrors ``repro``'s layout module for module (``repro_torch/core/tree.py``
is the counterpart of ``repro/core/tree.py``, and so on) and never imports
JAX or the ``repro`` package.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; the hand-written kernels live under
``csrc/`` and are built with ``nvcc`` at first use
(``repro_torch.kernels._build``).
"""
import torch

# The reference computes in full float32 throughout.  PyTorch's defaults
# would let cuDNN (and, on some versions, cuBLAS) round float32 products
# to TF32, which keeps only ~3 decimal digits, so both switches are set
# off explicitly for every process that imports the port.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
