"""Plain PyTorch version of the MCMC all-candidate move scorer (port of
``repro/kernels/mcmc_score/ref.py``).

Every MCMC move ratio is a bilinear form z^T A z against a per-chain
(2K x 2K) score matrix A (``core.mcmc.score_matrix``), so scoring every
candidate is a batch of quadratic forms.
"""
import torch


def score_all_ref(Z: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """s_{c,m} = z_m^T A_c z_m.  Z: (M, R) shared rows, A: (C, R, R)
    per-chain score matrices -> (C, M) float32."""
    z = Z.float()
    return torch.einsum("mi,cij,mj->cm", z, A.float(), z)
