"""Incremental (dual-form) proposal maintenance for dynamic catalogs (port
of ``repro/core/dynamic.py``).

The static sampler's tree holds the orthonormal eigenvector rows W of the
proposal kernel Lhat, a basis in which one catalog-row change moves every
row.  The dynamic catalog keeps the tree over the item-local dual rows

    a_j = z_j * xhat^{1/2}            (so Lhat = A A^T)

instead: the R x R dual Gram ``C = A^T A`` is exactly the tree root, and
its eigenpairs (lam, U) — an O(R^3) ``eigh`` of a matrix the tree already
maintains — drive the same descent, scoring and downdate machinery under
the initial projector ``Q0 = U_E diag(1/lam_E) U_E^T``
(``core.tree.dual_q0``).  So:

* a batched row change costs O(B (block + log M) R^2) (``update_rows``,
  the ``gathered_block_grams`` kernel) plus one R x R ``eigh``;
* the maintained tree is bit-equal to ``construct_tree`` on the mutated
  rows (touched nodes are recomputed, never delta-patched);
* a stale proposal snapshot stays usable: the acceptance test rescores the
  live kernel (``log_det_ratio(..., live_z=, live_x=)``), so draws stay
  exact while the snapshot dominates the live kernel (deletes, row
  downscales), at a rejection rate higher by det(Lhat_snap+I) /
  det(Lhat_live+I).

With a mesh, the proposal's tree and Z rows are item-sharded
(``tree.shard_tree``, ``tree.shard_spectral``), updates go to the owning
shard (``tree.update_rows_sharded``) and the rounds run sharded, all
bit-identical to the unsharded proposal.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from .. import random as trandom
from ..models import sharding as msh
from .rejection import (
    RejectionSample,
    _drive_rounds_fused,
    _fanout_traced,
    log_det_ratio,
)
from .tree import (
    AnyTree,
    construct_tree,
    sample_proposal_dpp_batch,
    shard_spectral,
    shard_tree,
    update_rows,
    update_rows_sharded,
)
from .types import SpectralNDPP


@dataclasses.dataclass(frozen=True)
class DualProposal:
    """A consistent proposal snapshot in the dual basis.

    Attributes:
      tree: flat sample tree over the dual rows A (``tree.W`` holds A,
        ``tree.lam`` the eigenvalues of C = A^T A, Lhat's nonzero spectrum).
      u: (R, R) eigenvectors of C (builds the ``dual_q0`` projectors).
      sp: the spectral state A was derived from; the acceptance denominator
        det(Lhat_Y) is scored against these rows, the kernel the tree
        proposes from, even after the live catalog has moved on.
    """

    tree: AnyTree
    u: torch.Tensor
    sp: SpectralNDPP

    @property
    def R(self) -> int:
        return self.tree.R


def dual_rows(sp: SpectralNDPP) -> torch.Tensor:
    """A = Z diag(xhat)^{1/2}: the item-local factor with Lhat = A A^T."""
    return sp.Z * torch.sqrt(sp.x_diag_hat())[None, :]


def dual_eigens(root: torch.Tensor, eps: float = 1e-10
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenpairs (lam, U) of the R x R dual Gram (the tree root), with null
    directions (lam <= eps) zeroed so their coin probability is 0."""
    lam, u = torch.linalg.eigh(root)
    lam = lam.clamp_min(0.0)
    return lam * (lam > eps), u


def build_dual_proposal(sp: SpectralNDPP, block: int = 64,
                        mesh=None) -> DualProposal:
    """The dual tree and eigens from scratch (catalog build and capacity
    doubling); the leaf level goes through ``block_outer_sums``.  With
    ``mesh``, the tree and Z are then placed item-sharded on it."""
    a = dual_rows(sp)
    tree = construct_tree(torch.zeros(a.shape[1], dtype=a.dtype,
                                      device=a.device), a, block=block)
    lam, u = dual_eigens(tree.root)
    prop = DualProposal(tree=dataclasses.replace(tree, lam=lam), u=u, sp=sp)
    return prop if mesh is None else shard_proposal(prop, mesh)


def shard_proposal(prop: DualProposal, mesh) -> DualProposal:
    """Place a proposal on a mesh: its tree and Z item-sharded
    (``shard_tree``, ``shard_spectral``), u replicated; one already on
    ``mesh`` keeps its arrays."""
    return DualProposal(tree=shard_tree(prop.tree, mesh),
                        u=prop.u.to(mesh.device),
                        sp=shard_spectral(prop.sp, mesh))


def update_proposal(prop: DualProposal, idx: torch.Tensor,
                    z_rows: torch.Tensor, new_sp: SpectralNDPP,
                    mesh=None) -> DualProposal:
    """Apply a batched row change to a proposal: the tree paths through
    ``update_rows`` (copy-on-write, bit-equal to a rebuild) and the dual
    eigens from the maintained root.  ``idx`` (B,) unique rows, ``z_rows``
    (B, R) new Z rows (zeros = delete), ``new_sp`` the updated spectral
    state the proposal now matches.  ``prop`` is left as it was.  With
    ``mesh`` every row goes to the shard owning it
    (``update_rows_sharded``), bit-equal to the unsharded update."""
    xhalf = torch.sqrt(new_sp.x_diag_hat())
    a_rows = z_rows * xhalf[None, :]
    if mesh is None:
        tree = update_rows(prop.tree, idx, a_rows)
    else:
        tree = update_rows_sharded(prop.tree, idx, a_rows, mesh)
    lam, u = dual_eigens(tree.root)
    return DualProposal(tree=dataclasses.replace(tree, lam=lam), u=u,
                        sp=new_sp)


# ------------------------------------------------------------ sampling rounds


def _spec_round_dual_impl(prop: DualProposal, live_sp: SpectralNDPP,
                          keys: torch.Tensor):
    """One speculative round against a (possibly stale) dual proposal: one
    proposal per key (N, 2) from Lhat_snap, accepted against the live
    kernel, with the key schedule of ``rejection._spec_round_impl`` — so a
    request's draw depends only on the state it is pinned to.  Returns
    (items, mask, accept) with leading dim N."""
    ks = trandom.split(keys)                                      # (N, 2, 2)
    items, mask = sample_proposal_dpp_batch(prop.tree, ks[:, 0],
                                            dual_u=prop.u)
    log_ratio, _ = log_det_ratio(prop.sp, items, mask, live_z=live_sp.Z,
                                 live_x=live_sp.x_matrix())
    u = trandom.uniform(ks[:, 1])
    return items, mask, torch.log(u) <= log_ratio


def _spec_round_dual_fused(prop: DualProposal, live_sp: SpectralNDPP,
                           slot_keys: torch.Tensor, trials: torch.Tensor, *,
                           n_spec: int):
    """One engine tick's round for slots pinned to one catalog state:
    proposal t of slot i is keyed ``fold_in(slot_keys[i], trials[i] + t)``.
    Returns (items, mask, accept) with leading dim n * n_spec."""
    offsets = torch.arange(n_spec, dtype=torch.int64, device=slot_keys.device)
    keys = _fanout_traced(slot_keys, trials, offsets)
    return _spec_round_dual_impl(prop, live_sp, keys)


# ------------------------------------------------------------------- drivers


def expected_trials_dynamic(prop: DualProposal,
                            live_sp: SpectralNDPP) -> torch.Tensor:
    """E[#trials] under a (possibly stale) proposal:
    det(Lhat_snap + I) / det(L_live + I), the numerator prod(1 + lam) over
    the snapshot's maintained eigenvalues, the denominator an R x R
    determinant.  Equals ``det_ratio_exact`` for a fresh snapshot."""
    ld_hat = torch.sum(torch.log1p(prop.tree.lam))
    z = msh.full_rows(live_sp.Z)
    g = z.T @ z
    eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    _, ld_l = torch.linalg.slogdet(eye + live_sp.x_matrix() @ g)
    return torch.exp(ld_hat - ld_l)


def auto_n_spec_dynamic(prop: DualProposal, live_sp: SpectralNDPP,
                        max_spec: int = 64) -> int:
    """Speculation depth ~ E[#trials] under the current snapshot (the next
    power of two, capped): the dynamic analog of ``auto_n_spec``."""
    expect = float(expected_trials_dynamic(prop, live_sp))
    return int(min(max_spec, max(2, 1 << int(math.ceil(
        math.log2(max(1.0, expect)))))))


def sample_dynamic_many(
    prop: DualProposal, live_sp: SpectralNDPP, key, n: Optional[int] = None,
    *, n_spec: Optional[int] = None, max_trials: int = 1000,
    max_spec: int = 64, split_keys: bool = True, mesh=None, observer=None,
) -> RejectionSample:
    """Speculative rejection sampling against a dynamic-catalog state.

    The contract of ``rejection.sample_batched_many`` (proposal t of
    request i is ``fold_in(req_key_i, t)``), driven by the same
    constant-width loop (``rejection._drive_rounds_fused``): the
    reference's growing ``drive_rounds`` schedule gives the same draws key
    for key, since no result depends on the schedule.  The proposal is a
    ``DualProposal`` snapshot and the acceptance test rescores ``live_sp``,
    so draws follow the live kernel exactly while the snapshot dominates
    it.  ``mesh``: place the proposal and ``live_sp`` on it
    (``shard_proposal``, ``shard_spectral``) and run the same rounds
    item-sharded, with the same draws.  Returns
    tensors on the proposal's (first) device.
    """
    if mesh is not None:
        prop = shard_proposal(prop, mesh)
        live_sp = shard_spectral(live_sp, mesh)
    if observer is not None:
        raise NotImplementedError(
            "observer= is not ported yet (ROADMAP, Queue 1: observability "
            "and the front door)")
    dev = prop.tree.device
    if n_spec is None:
        n_spec = auto_n_spec_dynamic(prop, live_sp, max_spec)
    key = trandom.as_key(key, dev)
    if split_keys:
        if n is None:
            raise ValueError("n is required when passing a single key")
        req_keys = trandom.split(key, n)
    else:
        req_keys = key
    return _drive_rounds_fused(
        lambda keys: _spec_round_dual_impl(prop, live_sp, keys), req_keys,
        prop.R, n_spec=n_spec, max_trials=max_trials)
