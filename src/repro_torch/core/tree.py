"""Sublinear-time tree-based DPP sampling (Section 4.2, Algorithm 3); port
of ``repro/core/tree.py``, unsharded.

The tree is flat, level-indexed and truncated at leaf blocks of ``block``
items: a traversal descends ``log2(M / block)`` levels (one <Q, Σ> inner
product on R x R matrices each) and then scores the whole leaf block at
once.  All levels live in ONE contiguous ``(2^(depth+1) - 1, R, R)`` node
stack (level ``l`` at nodes ``[2^l - 1, 2^(l+1) - 1)``), built once in
``construct_tree``, so the round kernel reads it in place and no call ever
concatenates or pads the levels (5.2 GB at M = 2^20, R = 200, block = 64).

The proposal DPP (Section 4.1) is ``Lhat = Z Xhat Z^T``; its eigenpairs
come from the R x R Gram of ``Z Xhat^1/2``, never from the M x M kernel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .. import random as trandom
from ..kernels.spec_round import ops as spec_ops
from ..kernels.tree_sum import ops as tree_sum_ops
from ..models import sharding as msh
from .types import SpectralNDPP


def proposal_eigens(sp: SpectralNDPP, eps: float = 1e-10
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigendecomposition of Lhat = A A^T via the R x R Gram of
    A = Z Xhat^{1/2}.  Returns lam (R,) (>= 0, zeros on the null space) and
    W (M, R) orthonormal eigenvector columns (zero where lam == 0)."""
    xhalf = torch.sqrt(sp.x_diag_hat())
    a = sp.Z * xhalf[None, :]
    g = a.T @ a
    lam, u = torch.linalg.eigh(g)
    lam = lam.clamp_min(0.0)
    good = lam > eps
    denom = torch.where(good, torch.sqrt(lam.clamp_min(eps)),
                        torch.ones_like(lam))
    w = (a @ u) / denom[None, :]
    w = w * good[None, :]
    lam = lam * good
    return lam, w


@dataclasses.dataclass(frozen=True)
class SampleTree:
    """Flat level-indexed tree over the rows of W (M_pad x R).

    ``nodes`` stacks every level root first; ``level(l)`` is the
    (2^l, R, R) view of level l, and ``nodes[0]`` = sum_j w_j w_j^T.  The
    deepest level has ``2^depth`` nodes of ``block`` consecutive (padded)
    items each.
    """

    W: torch.Tensor        # (M_pad, R) zero-padded rows
    lam: torch.Tensor      # (R,)
    nodes: torch.Tensor    # (2^(depth+1) - 1, R, R)
    block: int
    M: int                 # true item count

    @property
    def n_blocks(self) -> int:
        return self.W.shape[0] // self.block

    @property
    def depth(self) -> int:
        return self.n_blocks.bit_length() - 1

    @property
    def R(self) -> int:
        return self.W.shape[1]

    def level(self, lvl: int) -> torch.Tensor:
        return self.nodes[(1 << lvl) - 1:(1 << (lvl + 1)) - 1]

    @property
    def levels(self) -> Tuple[torch.Tensor, ...]:
        """Per-level views, root first (the reference's ``levels``)."""
        return tuple(self.level(lvl) for lvl in range(self.depth + 1))


def construct_tree(lam: torch.Tensor, W: torch.Tensor,
                   block: int = 64) -> SampleTree:
    """ConstructTree (Alg. 3) in flat form; O(M R^2 / block) node memory.

    The leaf level is written by the ``block_outer_sums`` kernel straight
    into its place in the node stack; each level above is the pairwise
    sum of the one below, written in place too.
    """
    m, r = W.shape
    n_blocks = max(1, 2 ** math.ceil(math.log2(max(1, math.ceil(m / block)))))
    m_pad = n_blocks * block
    wp = torch.nn.functional.pad(W, (0, 0, 0, m_pad - m)).contiguous()
    nodes = torch.empty((2 * n_blocks - 1, r, r), dtype=torch.float32,
                        device=W.device)
    depth = n_blocks.bit_length() - 1
    tree = SampleTree(W=wp, lam=lam, nodes=nodes, block=block, M=m)
    tree_sum_ops.block_outer_sums(wp, block, out=tree.level(depth))
    for lvl in range(depth - 1, -1, -1):
        child = tree.level(lvl + 1)
        torch.add(child[0::2], child[1::2], out=tree.level(lvl))
    return tree


def update_rows(tree: SampleTree, idx: torch.Tensor, rows: torch.Tensor,
                lam: Optional[torch.Tensor] = None) -> SampleTree:
    """Batched row update ``W[idx] <- rows`` in O(B (block + log M) R^2).

    ``idx``: (B,) unique row indices (several hitting one block are fine;
    a repeated row index is not), ``rows``: (B, R).  The touched leaf
    blocks are recomputed by the ``gathered_block_grams`` kernel and their
    root paths resummed (``kernels.tree_sum.ops.tree_update``), so the
    result is bit-equal to ``construct_tree`` on the updated rows.  The
    update is copy-on-write: ``tree`` is left as it was, so a snapshot that
    holds it stays valid.  ``lam`` optionally replaces the eigenvalues.
    """
    nodes, w_new = tree_sum_ops.tree_update(tree.nodes, tree.W, idx, rows,
                                            tree.block)
    return SampleTree(W=w_new, lam=tree.lam if lam is None else lam,
                      nodes=nodes, block=tree.block, M=tree.M)


def dual_q0(u: torch.Tensor, lam: torch.Tensor, e_masks: torch.Tensor,
            eps: float = 1e-10) -> torch.Tensor:
    """Elementary-DPP projectors for a dual tree (rows a_j = z_j x̂_j^1/2).

    With (lam, u) the eigenpairs of the R x R dual Gram C = A^T A (the tree
    root), the elementary DPP of eigenvector set E has marginal kernel
    A Q0 A^T with Q0 = U_E diag(1/lam_E) U_E^T.  e_masks: (N, R) -> (N, R, R).
    Null directions (lam <= eps) are never selected and contribute zero.
    """
    inv = torch.where(lam > eps, 1.0 / lam.clamp_min(eps),
                      torch.zeros_like(lam))
    w = e_masks.to(u.dtype) * inv[None, :]
    return torch.einsum("ik,nk,jk->nij", u, w, u)


def sample_elementary_batch(tree: SampleTree, e_masks: torch.Tensor,
                            keys: torch.Tensor,
                            q0: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """N elementary-DPP draws through the tree, one batched step per item.

    e_masks: (N, R) eigenvector selections, keys: (N, 2) one key per
    proposal.  Returns (items, mask), each (N, R); items are -1 past each
    lane's |E|.  Step t of lane n uses the reference's key schedule:
    ``kk = split(split(keys[n], R)[t])``, the descent uniforms from
    ``kk[0]`` and the leaf categorical from ``kk[1]``.  The trip count is
    the batch's largest |E| (one host read); the noise of all steps is
    drawn up front, since it does not depend on the draws.

    ``q0`` overrides the (N, R, R) initial projectors: the dual tree of
    ``core.dynamic`` passes ``dual_q0(u, lam, e_masks)``; the default is
    the orthonormal-basis projector diag(e_mask).
    """
    n, r = e_masks.shape
    dev = e_masks.device
    n_e = e_masks.sum(dim=1)                                      # (N,)
    n_steps = int(n_e.max()) if n else 0
    q = (torch.diag_embed(e_masks.to(tree.W.dtype)) if q0 is None
         else q0.contiguous())                                    # (N, R, R)
    items = torch.full((n, r), -1, dtype=torch.int64, device=dev)
    if n_steps == 0:
        return items, items >= 0
    kk = trandom.split(trandom.split(keys, r)[:, :n_steps])      # (N, T, 2, 2)
    us_all = trandom.uniform(kk[:, :, 0], (max(tree.depth, 1),))  # (N, T, d)
    gumbel_all = trandom.gumbel(kk[:, :, 1], (tree.block,))       # (N, T, b)
    for t in range(n_steps):
        active = t < n_e                                          # (N,)
        # descent + leaf scoring: the spec_round kernel on the card, its
        # plain version on the CPU; raw scores are unclamped
        blk, raw = spec_ops.descend_score(tree.nodes, tree.W, tree.block, q,
                                          us_all[:, t].contiguous())
        logits = torch.log(raw.clamp_min(0.0) + 1e-30)
        j_local = torch.argmax(gumbel_all[:, t] + logits, dim=-1)
        j = blk * tree.block + j_local
        w_j = msh.gather_row(tree.W, j)                           # (N, R)
        qw = torch.einsum("nij,nj->ni", q, w_j)
        p = torch.einsum("ni,ni->n", w_j, qw).clamp_min(1e-30)
        q_new = q - qw[:, :, None] * qw[:, None, :] / p[:, None, None]
        q = torch.where(active[:, None, None], q_new, q)
        items[:, t] = torch.where(active, j, torch.full_like(j, -1))
    return items, items >= 0


def sample_proposal_dpp_batch(tree: SampleTree, keys: torch.Tensor,
                              dual_u: Optional[torch.Tensor] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """N draws Y ~ DPP(Lhat), one per key in ``keys`` (N, 2): eigenvector
    coins with probability lam/(lam+1), then one batched tree descent.
    ``dual_u``: (R, R) eigenvectors of the dual Gram when ``tree`` holds
    dual rows (``core.dynamic``); the coins still use ``tree.lam`` and the
    projectors come from ``dual_q0``."""
    ks = trandom.split(keys)                                      # (N, 2, 2)
    probs = tree.lam / (tree.lam + 1.0)
    u_e = trandom.uniform(ks[:, 0], probs.shape)
    e_masks = u_e < probs[None, :]
    q0 = None if dual_u is None else dual_q0(dual_u, tree.lam, e_masks)
    return sample_elementary_batch(tree, e_masks, ks[:, 1], q0=q0)
