"""Plain PyTorch versions of the batched quadratic forms (port of
``repro/kernels/bilinear/ref.py``)."""
import torch


def bilinear_ref(Z: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """p_i = z_i^T W z_i in float32.  Z: (M, R), W: (R, R) -> (M,)."""
    z = Z.float()
    return torch.einsum("mi,ij,mj->m", z, W.float(), z)


def bilinear_batched_ref(Z: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """p_{n,b} = z_{n,b}^T W_n z_{n,b}.  Z: (N, B, R), W: (N, R, R) -> (N, B).

    One inner matrix per batch element: the speculative leaf-scoring
    layout (N proposals, each with its own conditioning projector).  The
    expression is ``spec_round.ref.leaf_scores_ref``'s, so the sharded
    descent's leaf scores equal the unsharded path's on the CPU."""
    z = Z.float()
    return torch.einsum("nbi,nij,nbj->nb", z, W.float(), z)
