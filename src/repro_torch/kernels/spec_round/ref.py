"""Plain PyTorch version of the fused round descent + leaf scoring (port of
``repro/kernels/spec_round/ref.py``).

The tree is the flat node stack of ``core.tree.SampleTree``: level ``l``
holds nodes ``[2^l - 1, 2^(l+1) - 1)``, root first.  The arithmetic follows
the reference oracle stage for stage: shallow levels are scored against
every node with one stacked matmul, deep levels gather the left child per
lane, and the parent's mass is carried down.
"""
import torch

#: levels with at most this many nodes are scored with one stacked matmul
#: instead of per-lane gathers (the reference's ``_SHALLOW_MAX``)
_SHALLOW_MAX = 32


def descend_ref(nodes: torch.Tensor, depth: int, q: torch.Tensor,
                us: torch.Tensor) -> torch.Tensor:
    """Root-to-block traversal for N lanes in lockstep.

    nodes: (2^(depth+1) - 1, R, R); q: (N, R, R) conditioning projectors;
    us: (N, >= depth) uniforms.  Returns the chosen block per lane (N,)
    int64.
    """
    n, r = q.shape[0], q.shape[-1]
    idx = torch.zeros(n, dtype=torch.int64, device=q.device)
    qf = q.reshape(n, r * r)
    p_all = qf @ nodes[0].reshape(r * r)
    # shallow levels 1..n_sh sit contiguously at nodes[1 : 2^(n_sh+1) - 1]
    n_sh = min(depth, _SHALLOW_MAX.bit_length() - 1)
    if n_sh:
        stacked = nodes[1:(1 << (n_sh + 1)) - 1].reshape(-1, r * r)
        all_scores = stacked @ qf.T                 # (sum 2^lvl, N)
    lanes = torch.arange(n, device=q.device)
    for lvl in range(1, depth + 1):
        if lvl <= n_sh:
            p_left = all_scores[(1 << lvl) - 2 + 2 * idx, lanes]
        else:
            left = nodes[(1 << lvl) - 1 + 2 * idx]  # (N, R, R) gather
            p_left = (q * left).sum(dim=(1, 2))
        go_left = us[:, lvl - 1] * p_all.clamp_min(1e-30) \
            <= p_left.clamp_min(0.0)
        idx = 2 * idx + (~go_left).long()
        p_all = torch.where(go_left, p_left, p_all - p_left).clamp_min(0.0)
    return idx


def leaf_scores_ref(W: torch.Tensor, block: int, blk: torch.Tensor,
                    q: torch.Tensor) -> torch.Tensor:
    """Raw (unclamped) leaf-block scores z^T Q_n z for each lane's chosen
    block: (N, block)."""
    rows = blk[:, None] * block + torch.arange(block, device=blk.device)
    w_blk = W[rows]                                   # (N, block, R)
    return torch.einsum("nbi,nij,nbj->nb", w_blk, q, w_blk)


def descend_score_ref(nodes: torch.Tensor, W: torch.Tensor, block: int,
                      q: torch.Tensor, us: torch.Tensor):
    """(chosen block per lane (N,) int64, raw scores (N, block))."""
    depth = (W.shape[0] // block).bit_length() - 1
    blk = descend_ref(nodes, depth, q, us)
    return blk, leaf_scores_ref(W, block, blk, q)
