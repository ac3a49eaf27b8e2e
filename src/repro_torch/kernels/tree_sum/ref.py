"""Plain PyTorch versions of the tree leaf-level Gram reductions (port of
``repro/kernels/tree_sum/ref.py``)."""
import torch


def block_outer_sums_ref(W: torch.Tensor, block: int) -> torch.Tensor:
    """W: (n*block, R) -> (n, R, R), out[n] = sum_{j in block n} w_j w_j^T."""
    m, r = W.shape
    if m % block:
        raise ValueError(f"row count {m} is not a multiple of block {block}")
    wb = W.reshape(m // block, block, r).float()
    return torch.einsum("nbi,nbj->nij", wb, wb)


def gathered_block_grams_ref(W: torch.Tensor, blks: torch.Tensor,
                             block: int) -> torch.Tensor:
    """Grams of the leaf blocks named by ``blks`` only: W (n*block, R),
    blks (nb,) integer block ids -> (nb, R, R).  The same per-block
    contraction as ``block_outer_sums_ref``, so a recomputed block is
    bit-equal to the same block of a full build (the tests hold this)."""
    rows = blks.long()[:, None] * block + torch.arange(
        block, device=W.device)[None, :]
    wb = W[rows].float()
    return torch.einsum("nbi,nbj->nij", wb, wb)
