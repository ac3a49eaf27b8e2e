"""Plain PyTorch version of the tree leaf-level Gram reduction (port of
``repro/kernels/tree_sum/ref.py``)."""
import torch


def block_outer_sums_ref(W: torch.Tensor, block: int) -> torch.Tensor:
    """W: (n*block, R) -> (n, R, R), out[n] = sum_{j in block n} w_j w_j^T."""
    m, r = W.shape
    if m % block:
        raise ValueError(f"row count {m} is not a multiple of block {block}")
    wb = W.reshape(m // block, block, r).float()
    return torch.einsum("nbi,nbj->nij", wb, wb)
