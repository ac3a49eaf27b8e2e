"""Shared primitive: batched bilinear forms ``p_i = z_i^T W z_i`` over items
(port of ``repro/core/bilinear.py``).

Leaf-block scores, Cholesky marginals and greedy-MAP gains are all this
primitive with different R x R inner matrices W; ``conditional_inner_matrix``
gives the one of greedy MAP and next-item scores (Gartrell et al. 2021,
Sec. 4.2).  ``bilinear_scores`` is
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


def conditional_inner_matrix(Z_obs: torch.Tensor, mask: torch.Tensor,
                             X: torch.Tensor, eps: float = 1e-6
                             ) -> torch.Tensor:
    """Inner matrix of the Schur complement of L given observed rows.

    For an observed set J with (padded) rows ``Z_obs`` (k_pad, R) and row
    mask ``mask`` (k_pad,) the conditional score of item i is

        det(L_{J u i}) / det(L_J) = z_i^T W_J z_i,
        W_J = X - X Z_J^T (Z_J X Z_J^T)^{-1} Z_J X.

    Padding rows are neutralised by the mask and a unit diagonal."""
    zj = Z_obs * mask[:, None]
    right = zj @ X                 # Z_J X            (k_pad, R)
    left = X @ zj.T                # X Z_J^T          (R, k_pad)
    g = right @ zj.T               # Z_J X Z_J^T
    eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    g = g + torch.diag(1.0 - mask) + eps * eye
    sol = torch.linalg.solve(g, right)  # (k_pad, R)
    # X is not symmetric (skew blocks): the left factor must be X Z_J^T,
    # not (Z_J X)^T = X^T Z_J^T
    return X - left @ sol


def conditional_scores(Z: torch.Tensor, Z_obs: torch.Tensor,
                       mask: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """det(L_{J u i})/det(L_J) for every item i (rows of Z), through the
    ``bilinear`` kernel (``bilinear_scores_fast``)."""
    return bilinear_scores_fast(
        Z, conditional_inner_matrix(Z_obs, mask, X).contiguous())
