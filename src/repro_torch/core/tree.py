"""Sublinear-time tree-based DPP sampling (Section 4.2, Algorithm 3); port
of ``repro/core/tree.py``.

The tree is flat, level-indexed and truncated at leaf blocks of ``block``
items: a traversal descends ``log2(M / block)`` levels (one <Q, Σ> inner
product on R x R matrices each) and then scores the whole leaf block at
once.  All levels live in ONE contiguous ``(2^(depth+1) - 1, R, R)`` node
stack (level ``l`` at nodes ``[2^l - 1, 2^(l+1) - 1)``), built once in
``construct_tree``, so the round kernel reads it in place and no call ever
concatenates or pads the levels (5.2 GB at M = 2^20, R = 200, block = 64).

The proposal DPP (Section 4.1) is ``Lhat = Z Xhat Z^T``; its eigenpairs
come from the R x R Gram of ``Z Xhat^1/2``, never from the M x M kernel.

Item-axis sharding (``shard_tree``, ``ShardedTree``): shard s of S owns
leaf blocks [s n_blocks/S, (s+1) n_blocks/S) and the matching rows of W;
levels with at most ``_SHALLOW_MAX`` nodes (the root included) are
replicated.  The levels are pairwise sums of contiguous children, so a
shard's slice of a deep level is exactly the sub-tree over its own
blocks.  A sharded descent scores each deep level's left child on the
shard that owns it and sums the partials (``models.sharding.psum``, one
owner plus exact zeros), so it visits the same blocks as the unsharded
descent bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple, Union

import torch

from .. import random as trandom
from ..kernels.bilinear import ops as bilinear_ops
from ..kernels.spec_round import ops as spec_ops
from ..kernels.spec_round.ref import _SHALLOW_MAX
from ..kernels.tree_sum import ops as tree_sum_ops
from ..models import sharding as msh
from .types import SpectralNDPP

#: the deepest replicated level: levels 0.._N_TOP have at most
#: _SHALLOW_MAX nodes, are replicated on every shard and are scored with
#: the descent's stacked matmul
_N_TOP = _SHALLOW_MAX.bit_length() - 1


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

    @property
    def device(self) -> torch.device:
        return self.W.device

    @property
    def root(self) -> torch.Tensor:
        """sum_j w_j w_j^T (R, R)."""
        return self.nodes[0]

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


# --------------------------------------------------------------------------
# Item-axis sharding.  A ShardedTree keeps the replicated shallow levels as
# one contiguous stack on the mesh's first device and every deeper level
# as a ``ShardedRows`` over its node axis (replicated instead when the
# mesh extent does not divide it); W is sharded by whole leaf blocks.
# Placing a tree on a mesh whose devices already hold it makes views, not
# copies.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardedTree:
    """A ``SampleTree`` placed on a mesh (``shard_tree``).

    ``top`` stacks levels 0..min(depth, 5) (at most ``_SHALLOW_MAX`` nodes
    each), root first, on ``mesh.device``; ``deep[i]`` is level
    ``_N_TOP + 1 + i``, a ``ShardedRows`` of its nodes or, where the mesh
    extent does not divide its node count, one replicated tensor.  ``W``
    is a ``ShardedRows`` of whole leaf blocks, or replicated when
    ``M_pad`` is not a multiple of S * block.
    """

    mesh: object
    top: torch.Tensor
    deep: Tuple[msh.Rows, ...]
    W: msh.Rows
    lam: torch.Tensor
    block: int
    M: int

    @property
    def n_blocks(self) -> int:
        return self.W.shape[0] // self.block

    @property
    def depth(self) -> int:
        return self.n_blocks.bit_length() - 1

    @property
    def R(self) -> int:
        return self.W.shape[1]

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    @property
    def root(self) -> torch.Tensor:
        return self.top[0]

    def level(self, lvl: int) -> msh.Rows:
        """Level ``lvl``: a view into ``top`` or an entry of ``deep``."""
        if lvl <= _N_TOP:
            return self.top[(1 << lvl) - 1:(1 << (lvl + 1)) - 1]
        return self.deep[lvl - _N_TOP - 1]


AnyTree = Union[SampleTree, ShardedTree]


def tree_shard_specs(tree: SampleTree, mesh) -> dict:
    """Where ``shard_tree`` puts each array (the reference's SampleTree of
    PartitionSpecs): ``{"W": spec, "levels": (spec, ...), "lam": spec}``
    with "model" on a sharded axis and None on a replicated one.  Levels
    with more than ``_SHALLOW_MAX`` nodes shard when the mesh extent
    divides them; W shards only when every shard gets whole leaf blocks
    (``M_pad % (S * block) == 0``), so a leaf block never straddles
    shards."""
    s = msh.model_extent(mesh)
    levels = tuple(
        msh.logical_to_spec(mesh, ("items", None, None), (1 << lvl, 0, 0))
        if (1 << lvl) > _SHALLOW_MAX else (None, None, None)
        for lvl in range(tree.depth + 1))
    w_spec = (msh.logical_to_spec(mesh, ("items", None), tree.W.shape)
              if tree.W.shape[0] % (s * tree.block) == 0 else (None, None))
    return {"W": w_spec, "levels": levels, "lam": (None,)}


def _place(x: torch.Tensor, spec, mesh) -> msh.Rows:
    return (msh.shard_rows(x, mesh) if spec[0] == "model"
            else x.to(mesh.device))


def shard_tree(tree: AnyTree, mesh) -> ShardedTree:
    """Place a tree on ``mesh``: deep levels and W item-sharded, shallow
    levels and lam replicated (``tree_shard_specs``).  The placed tree
    samples bit-identically to ``tree`` through the same entry points."""
    if isinstance(tree, ShardedTree):
        if tree.mesh == mesh:
            return tree
        tree = gather_tree(tree)
    specs = tree_shard_specs(tree, mesh)
    n_top = min(tree.depth, _N_TOP)
    return ShardedTree(
        mesh=mesh, top=tree.nodes[:(1 << (n_top + 1)) - 1].to(mesh.device),
        deep=tuple(_place(tree.level(lvl), specs["levels"][lvl], mesh)
                   for lvl in range(n_top + 1, tree.depth + 1)),
        W=_place(tree.W, specs["W"], mesh), lam=tree.lam.to(mesh.device),
        block=tree.block, M=tree.M)


def gather_tree(tree: AnyTree) -> SampleTree:
    """The plain ``SampleTree`` of a placed tree, on the mesh's first
    device (a copy of every level)."""
    if isinstance(tree, SampleTree):
        return tree
    nodes = torch.cat([tree.top] + [msh.full_rows(lv) for lv in tree.deep])
    return SampleTree(W=msh.full_rows(tree.W), lam=tree.lam, nodes=nodes,
                      block=tree.block, M=tree.M)


def shard_spectral(sp: SpectralNDPP, mesh) -> SpectralNDPP:
    """Place a SpectralNDPP on ``mesh``: Z rows item-sharded (replicated
    when M does not divide the mesh), sigma replicated."""
    return SpectralNDPP(Z=msh.shard_rows(sp.Z, mesh),
                        sigma=sp.sigma.to(mesh.device))


def update_rows_sharded(tree: AnyTree, idx: torch.Tensor, rows: torch.Tensor,
                        mesh) -> ShardedTree:
    """``update_rows`` for a tree placed on ``mesh`` (placed first if it is
    not).  Each row update goes to the shard owning it, which scatters its
    W rows and recomputes the touched leaf Grams (``gathered_block_grams``
    on its own rows); every level is then patched on the shard owning the
    node, the replicated levels from the psum of the owners' values (exact
    zeros elsewhere), so the result is bit-equal to the plain
    ``update_rows`` and to a rebuild.  Copy-on-write, as ``update_rows``."""
    tree = shard_tree(tree, mesh)
    block, dev = tree.block, tree.device
    idx = idx.to(dev, torch.int64)
    blks = idx // block
    w_new = msh.scatter_rows(tree.W, idx, rows.to(dev, torch.float32))
    if isinstance(w_new, msh.ShardedRows):
        parts = []
        for s, (w_loc, d) in enumerate(zip(w_new.parts, mesh.devices)):
            own, loc = msh.owned(blks.to(d), s, w_loc.shape[0] // block)
            g = tree_sum_ops.gathered_block_grams(w_loc, loc, block)
            parts.append(torch.where(own[:, None, None], g, 0.0))
        vals = msh.psum(parts, dev)
    else:
        vals = tree_sum_ops.gathered_block_grams(w_new, blks, block)
    top = tree.top.clone()
    deep = list(tree.deep)
    nodes = blks
    for lvl in range(tree.depth, -1, -1):
        arr = tree.level(lvl)
        if lvl <= _N_TOP:
            arr = top[(1 << lvl) - 1:(1 << (lvl + 1)) - 1]
            arr[nodes] = vals
        elif isinstance(arr, msh.ShardedRows):
            new = []
            for s, (part, d) in enumerate(zip(arr.parts, mesh.devices)):
                own, loc = msh.owned(nodes.to(d), s, part.shape[0])
                p = part.clone()
                p[loc[own]] = vals.to(d)[own]
                new.append(p)
            arr = deep[lvl - _N_TOP - 1] = msh.ShardedRows(mesh, tuple(new))
        else:
            arr = arr.clone()
            arr[nodes] = vals
            deep[lvl - _N_TOP - 1] = arr
        if lvl == 0:
            break
        parents = nodes // 2
        if isinstance(arr, msh.ShardedRows):
            # both children from their owners: one owner, exact zeros
            parts = []
            for s, (part, d) in enumerate(zip(arr.parts, mesh.devices)):
                pd = parents.to(d)
                own_l, loc_l = msh.owned(2 * pd, s, part.shape[0])
                own_r, loc_r = msh.owned(2 * pd + 1, s, part.shape[0])
                parts.append(torch.where(own_l[:, None, None], part[loc_l], 0.0)
                             + torch.where(own_r[:, None, None], part[loc_r],
                                           0.0))
            vals = msh.psum(parts, dev)
        else:
            vals = arr[2 * parents] + arr[2 * parents + 1]
        nodes = parents
    return ShardedTree(mesh=mesh, top=top, deep=tuple(deep), W=w_new,
                       lam=tree.lam, block=block, M=tree.M)


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


def _descend_batch(tree: ShardedTree, q: torch.Tensor,
                   us: torch.Tensor) -> torch.Tensor:
    """Root-to-block traversal of a placed tree for N lanes in lockstep:
    the arithmetic of ``kernels.spec_round.ref.descend_ref``, expression
    for expression, with each sharded level's left-child score taken on
    the shard owning the node and psum'd (the other shards add exact
    zeros).  q: (N, R, R), us: (N, >= depth).  Returns the chosen block
    per lane (N,) int64."""
    n, r = q.shape[0], q.shape[-1]
    dev = tree.device
    idx = torch.zeros(n, dtype=torch.int64, device=dev)
    qf = q.reshape(n, r * r)
    p_all = qf @ tree.root.reshape(r * r)
    n_sh = min(tree.depth, _N_TOP)
    if n_sh:
        all_scores = tree.top[1:].reshape(-1, r * r) @ qf.T  # (nodes, N)
    lanes = torch.arange(n, device=dev)
    for lvl in range(1, tree.depth + 1):
        nodes = tree.level(lvl)
        if lvl <= n_sh:
            p_left = all_scores[(1 << lvl) - 2 + 2 * idx, lanes]
        elif isinstance(nodes, msh.ShardedRows):
            parts = []
            for s, (part, d) in enumerate(zip(nodes.parts,
                                              tree.mesh.devices)):
                own, loc = msh.owned((2 * idx).to(d), s, part.shape[0])
                left = part[loc]                                # (N, R, R)
                parts.append(torch.where(
                    own, (q.to(d) * left).sum(dim=(1, 2)), 0.0))
            p_left = msh.psum(parts, dev)
        else:
            p_left = (q * nodes[2 * idx]).sum(dim=(1, 2))
        go_left = us[:, lvl - 1] * p_all.clamp_min(1e-30) \
            <= p_left.clamp_min(0.0)
        idx = 2 * idx + (~go_left).long()
        p_all = torch.where(go_left, p_left, p_all - p_left).clamp_min(0.0)
    return idx


def _leaf_scores_batch(w_blk: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Raw leaf scores for N lanes: (N, block, R) x (N, R, R) -> (N, block)
    through the ``bilinear_batched`` kernel (its plain version on the CPU)."""
    return bilinear_ops.bilinear_batched(w_blk, q)


def _leaf_scores_sharded(tree: ShardedTree, blk: torch.Tensor,
                         q: torch.Tensor) -> torch.Tensor:
    """Raw scores of each lane's chosen block, scored by the shard owning
    the block's rows and psum'd (exact zeros from the other shards)."""
    block = tree.block
    if not isinstance(tree.W, msh.ShardedRows):
        rows = blk[:, None] * block + torch.arange(block, device=blk.device)
        return _leaf_scores_batch(tree.W[rows], q)
    parts = []
    for s, (w_loc, d) in enumerate(zip(tree.W.parts, tree.mesh.devices)):
        own, loc = msh.owned(blk.to(d), s, w_loc.shape[0] // block)
        rows = loc[:, None] * block + torch.arange(block, device=d)
        raw = _leaf_scores_batch(w_loc[rows], q.to(d))
        parts.append(torch.where(own[:, None], raw, 0.0))
    return msh.psum(parts, tree.device)


def sample_elementary_batch(tree: AnyTree, e_masks: torch.Tensor,
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

    A ``SampleTree`` descends and scores in the ``descend_score`` kernel; a
    ``ShardedTree`` descends in ``_descend_batch`` and scores its leaf
    blocks on their owning shards with the ``bilinear_batched`` kernel,
    and the chosen item's row comes from its owner, so the draws equal
    the unsharded ones for any shard count (on the card up to the
    decisions the two descents round differently: near ties).
    """
    n, r = e_masks.shape
    dev = e_masks.device
    sharded = isinstance(tree, ShardedTree)
    n_e = e_masks.sum(dim=1)                                      # (N,)
    n_steps = int(n_e.max()) if n else 0
    q = (torch.diag_embed(e_masks.to(tree.lam.dtype)) if q0 is None
         else q0.contiguous())                                    # (N, R, R)
    items = torch.full((n, r), -1, dtype=torch.int64, device=dev)
    if n_steps == 0:
        return items, items >= 0
    kk = trandom.split(trandom.split(keys, r)[:, :n_steps])      # (N, T, 2, 2)
    us_all = trandom.uniform(kk[:, :, 0], (max(tree.depth, 1),))  # (N, T, d)
    gumbel_all = trandom.gumbel(kk[:, :, 1], (tree.block,))       # (N, T, b)
    for t in range(n_steps):
        active = t < n_e                                          # (N,)
        # descent + leaf scoring; raw scores are unclamped
        if sharded:
            blk = _descend_batch(tree, q, us_all[:, t])
            raw = _leaf_scores_sharded(tree, blk, q)
        else:
            blk, raw = spec_ops.descend_score(tree.nodes, tree.W, tree.block,
                                              q, us_all[:, t].contiguous())
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


def sample_proposal_dpp_batch(tree: AnyTree, keys: torch.Tensor,
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


def sample_proposal_dpp_batch_sharded(tree: AnyTree, keys: torch.Tensor, mesh,
                                      dual_u: Optional[torch.Tensor] = None
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sample_proposal_dpp_batch`` with the tree on ``mesh`` (placed
    first if it is not): deep-level descent and leaf scoring run on the
    shard owning the nodes and rows, combined by psums of exact zeros, so
    draws equal the unsharded sampler's for any shard count.  Returns
    (items, mask) on the mesh's first device."""
    return sample_proposal_dpp_batch(
        shard_tree(tree, mesh), keys.to(mesh.device),
        dual_u=None if dual_u is None else dual_u.to(mesh.device))


def sample_elementary_batch_sharded(tree: AnyTree, e_masks: torch.Tensor,
                                    keys: torch.Tensor, mesh
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``sample_elementary_batch`` through a tree on ``mesh`` (see
    ``sample_proposal_dpp_batch_sharded``)."""
    return sample_elementary_batch(shard_tree(tree, mesh),
                                   e_masks.to(mesh.device),
                                   keys.to(mesh.device))


# --------------------------------------------------------------------------
# One draw at a time.  A single elementary or proposal draw is the batched
# draw of one lane: the key schedule is the same (step t of a draw uses
# ``split(split(key, R)[t])``), so it runs ``descend_score`` on the card
# and equals the reference's single-draw descent on the same tree and key
# (up to decisions the two descents round differently: near ties).
# --------------------------------------------------------------------------


def sample_elementary(tree: AnyTree, e_mask: torch.Tensor, key
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One draw from the elementary DPP with marginal kernel W_E W_E^T:
    e_mask (R,) the eigenvectors E, key (2,).  Returns (items, mask), each
    (R,); items are -1 past |E|.  Row 0 of ``sample_elementary_batch``."""
    key = trandom.as_key(key, tree.device)
    items, mask = sample_elementary_batch(tree, e_mask[None], key[None])
    return items[0], mask[0]


def sample_proposal_dpp(tree: AnyTree, key
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One draw Y ~ DPP(Lhat): eigenvector coins with probability
    lam/(lam+1), then the elementary draw through the tree.  Row 0 of
    ``sample_proposal_dpp_batch``."""
    key = trandom.as_key(key, tree.device)
    items, mask = sample_proposal_dpp_batch(tree, key[None])
    return items[0], mask[0]


def _leaf_scores(w_blk: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Raw scores z_b^T Q z_b of rows (B, R) against one projector (R, R)
    -> (B,), through the ``bilinear`` kernel (its plain version on the
    CPU)."""
    return bilinear_ops.bilinear(w_blk.contiguous(), q.contiguous())


def sample_elementary_dense(W: torch.Tensor, e_mask: torch.Tensor, key
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(M k R) oracle: the distribution of ``sample_elementary``
    without a tree, scoring every row of W (M, R) at each step
    (``_leaf_scores`` over all rows).  Step t draws its item by
    ``categorical(split(key, R)[t], log(scores + 1e-30))``, then downdates
    Q by the chosen row.  Returns (items, mask), each (R,)."""
    m, r = W.shape
    keys = trandom.split(trandom.as_key(key, W.device), r)
    q = torch.diag(e_mask.to(W.dtype))
    items = torch.full((r,), -1, dtype=torch.int64, device=W.device)
    for t in range(int(e_mask.sum())):
        scores = _leaf_scores(W, q).clamp_min(0.0)
        j = trandom.categorical(keys[t], torch.log(scores + 1e-30))
        w_j = W[j]
        qw = q @ w_j
        p = (w_j @ qw).clamp_min(1e-30)
        q = q - torch.outer(qw, qw) / p
        items[t] = j
    return items, items >= 0
