"""Shared primitive: batched bilinear forms ``p_i = z_i^T W z_i`` over items
(port of ``repro/core/bilinear.py``; the conditional scores come with the
learning slice).

Leaf-block scores, Cholesky marginals and greedy-MAP gains are all this
primitive with different R x R inner matrices W.  ``bilinear_scores`` is
the plain PyTorch form; ``bilinear_scores_fast`` goes through the
``bilinear`` kernel (``kernels/bilinear``), on the card a launch of
``csrc/bilinear.cu`` and on the CPU the kernel's plain version.
"""
from __future__ import annotations

import torch

from ..kernels.bilinear import ops as bilinear_ops


def bilinear_scores(Z: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """p_i = z_i^T W z_i for all rows z_i of Z.  Z: (M, R), W: (R, R)."""
    return torch.einsum("mi,ij,mj->m", Z, W, Z)


def bilinear_scores_fast(Z: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``bilinear_scores`` through the ``bilinear`` kernel."""
    return bilinear_ops.bilinear(Z, W)
