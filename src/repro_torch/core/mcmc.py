"""MCMC sampling for NDPPs: low-rank up/down/swap Metropolis chains (port of
``repro/core/mcmc.py``, without telemetry).

For an unconstrained NDPP the rejection sampler's rate det(Lhat+I)/det(L+I)
is unbounded, so this module samples Pr(Y) ∝ det(L_Y) with a
Metropolis-Hastings chain over subsets instead (Han et al. 2022):

  * NDPP (variable size): propose toggling a uniform item (add/remove,
    symmetric), mixed with an occasional swap move;
  * k-NDPP (fixed size): propose swapping a uniform occupied slot for a
    uniform item (proposals hitting Y are lazy no-ops).

Every proposal is scored in O(K^2) against the cached inverse
``P = (L_Y)^{-1}`` of the padded |Y| x |Y| kernel submatrix (padded to
R = 2K with an identity block, so shapes never change):

  add j:     det(L_{Y+j})/det(L_Y)   = z_j^T X z_j - v^T P u
  remove s:  det(L_{Y-s})/det(L_Y)   = P[s, s]
  swap s->j: det(L_{Y-s+j})/det(L_Y) = P[s,s] (z_j^T X z_j - v^T P u)
                                       + (v^T P)[s] (P u)[s]

with ``u = Z_Y X z_j`` and ``v = Z_Y X^T z_j``.  Accepted moves update P by
rank-1 formulas; a periodic full inverse bounds float32 drift.  The add
ratio of every candidate at once is a bilinear form z_j^T A z_j, scored for
the greedy chain start by the ``score_all`` kernel (``kernels/mcmc_score``).

Layout: every function works on a batch of C chains (the reference's
``vmap``), an ``MCMCState`` of tensors with leading dim C.  Step t of a
chain draws its randomness from ``fold_in(chain_key, t)`` (the reference's
key schedule, bit for bit), so a trajectory does not depend on batching or
on how its steps are split across calls.  The noise of a call's steps does
not depend on the chain states and is drawn up front; ``lax.scan`` becomes
a Python loop of batched steps.

Sharded (``run_chains_sharded``): the catalog rows Z are split over a
mesh and the chain states stay on its first device; only a candidate's
row z_j and the <= 2K subset rows cross shards, each fetched from its
owner by a psum of exact zeros (``models.sharding``), so trajectories
equal the unsharded chains'.  Candidates are drawn over the global M.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import random as trandom
from ..kernels.mcmc_score import ops as mcmc_score_ops
from ..models import sharding as msh
from .tree import shard_spectral
from .types import SpectralNDPP

_TINY = 1e-30
_PIVOT_EPS = 1e-8  # smallest remove pivot a composed swap update may divide by


class MCMCState(NamedTuple):
    """States of C chains: padded subsets and cached padded inverses.

    ``minv[c]`` is the inverse of ``Z_Y X Z_Y^T + diag(~mask)``: block
    diagonal between occupied and padding slots, identity on the padding.
    """

    items: torch.Tensor  # (C, R) int64 item ids, -1 on padding slots
    mask: torch.Tensor   # (C, R) bool
    minv: torch.Tensor   # (C, R, R) float32 inverse of the padded L_Y
    step: torch.Tensor   # (C,) int64 MH steps taken (drives the keys)


class MCMCSample(NamedTuple):
    items: torch.Tensor        # (n, R) padded item ids
    mask: torch.Tensor         # (n, R)
    steps: torch.Tensor        # (n,) chain step each sample was read at
    accept_rate: torch.Tensor  # () mean MH acceptance over all steps


# ---------------------------------------------------------------- state core


def _rows(n: int, dev: torch.device) -> torch.Tensor:
    return torch.arange(n, device=dev)


def _masked_rows(Z: msh.Rows, items: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """Subset rows ``Z[items] * mask``; a row-sharded Z's rows come from
    their owners (``models.sharding.gather_rows``), bit-equal."""
    return msh.gather_rows(Z, items, mask)


def _padded_l(Z: msh.Rows, x: torch.Tensor, items: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    zy = _masked_rows(Z, items, mask)
    return zy @ x @ zy.transpose(-1, -2) + torch.diag_embed(
        (~mask).to(Z.dtype))


def _inv(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse that never raises or syncs on a singular matrix (the
    reference's ``jnp.linalg.inv`` returns non-finite values there, and
    every caller masks or vetoes them)."""
    return torch.linalg.inv_ex(a)[0]


def refresh(sp: SpectralNDPP, state: MCMCState) -> MCMCState:
    """Full O(R^3) recompute of every chain's cached inverse."""
    ly = _padded_l(sp.Z, sp.x_matrix(), state.items, state.mask)
    return state._replace(minv=_inv(ly))


def reanchor(sp: SpectralNDPP, states: MCMCState) -> MCMCState:
    """Re-anchor a pool of chains on a new catalog version: drop subset
    items whose live row is now exactly zero (deleted items), then
    recompute each cached inverse against the new rows.  Step counters are
    kept, so the chains' later randomness does not depend on when the swap
    happened."""
    rows = _masked_rows(sp.Z, states.items, states.mask)
    live = (rows.abs() > 0).any(dim=-1)
    mask = states.mask & live
    items = torch.where(mask, states.items, torch.full_like(states.items, -1))
    return refresh(sp, states._replace(items=items, mask=mask))


def init_empty(sp: SpectralNDPP, n_chains: int = 1) -> MCMCState:
    """C = ``n_chains`` chains at Y = ∅ (det = 1, inverse = identity, step
    0): the up/down chain's start."""
    r = sp.Z.shape[1]
    dev = sp.Z.device
    return MCMCState(
        items=torch.full((n_chains, r), -1, dtype=torch.int64, device=dev),
        mask=torch.zeros((n_chains, r), dtype=torch.bool, device=dev),
        minv=torch.eye(r, dtype=torch.float32, device=dev).repeat(
            n_chains, 1, 1),
        step=torch.zeros(n_chains, dtype=torch.int64, device=dev))


def _uvt(Z: msh.Rows, x: torch.Tensor, state: MCMCState,
         j: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per chain: u = Z_Y X z_j, v = Z_Y X^T z_j (v_r = L[j, r]),
    t = L[j, j].  j: (C,) -> u, v (C, R), t (C,)."""
    zy = _masked_rows(Z, state.items, state.mask)                 # (C, R, R)
    zj = msh.gather_row(Z, j)                                     # (C, R)
    xz = zj @ x.T                                                 # X z_j
    xtz = zj @ x                                                  # X^T z_j
    u = torch.einsum("cri,ci->cr", zy, xz)
    v = torch.einsum("cri,ci->cr", zy, xtz)
    t = torch.einsum("ci,ci->c", zj, xz)
    return u, v, t


def _diag_at(minv: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    return minv[_rows(minv.shape[0], minv.device), slot, slot]


# ------------------------------------------------------------ ratio formulas


def add_ratio(sp: SpectralNDPP, state: MCMCState,
              j: torch.Tensor) -> torch.Tensor:
    """det(L_{Y∪j}) / det(L_Y) per chain, O(K^2) from the cached inverse."""
    u, v, t = _uvt(sp.Z, sp.x_matrix(), state, j)
    return t - torch.einsum("ci,cij,cj->c", v, state.minv, u)


def remove_ratio(state: MCMCState, slot: torch.Tensor) -> torch.Tensor:
    """det(L_{Y∖items[slot]}) / det(L_Y) = minv[slot, slot] (Cramer)."""
    return _diag_at(state.minv, slot)


def swap_ratio(sp: SpectralNDPP, state: MCMCState, slot: torch.Tensor,
               j: torch.Tensor) -> torch.Tensor:
    """det(L_{Y∖items[slot]∪j}) / det(L_Y) in one O(K^2) pass: the Cramer
    removal composed with the Schur addition."""
    u, v, t = _uvt(sp.Z, sp.x_matrix(), state, j)
    rows = _rows(u.shape[0], u.device)
    pu = torch.einsum("cij,cj->ci", state.minv, u)
    vp = torch.einsum("ci,cij->cj", v, state.minv)
    return (_diag_at(state.minv, slot) * (t - (v * pu).sum(-1))
            + vp[rows, slot] * pu[rows, slot])


def score_matrix(sp: SpectralNDPP, state: MCMCState) -> torch.Tensor:
    """A = X - X Z_Y^T P Z_Y X per chain (C, R, R): add-ratio(j) =
    z_j^T A z_j for every j (what ``score_all`` consumes)."""
    x = sp.x_matrix()
    zy = _masked_rows(sp.Z, state.items, state.mask)
    g = zy.transpose(-1, -2) @ (state.minv @ zy)
    return x - x @ g @ x


def swap_score_matrix(sp: SpectralNDPP, state: MCMCState,
                      slot: torch.Tensor) -> torch.Tensor:
    """A_swap per chain with swap-ratio(slot -> j) = z_j^T A_swap z_j."""
    x = sp.x_matrix()
    zy = _masked_rows(sp.Z, state.items, state.mask)
    rows = _rows(zy.shape[0], zy.device)
    col = state.minv[rows, :, slot]                               # (C, R)
    row = state.minv[rows, slot, :]
    p = torch.einsum("ij,cj->ci", x, torch.einsum("cri,cr->ci", zy, col))
    q = torch.einsum("ji,cj->ci", x, torch.einsum("cri,cr->ci", zy, row))
    return (_diag_at(state.minv, slot)[:, None, None] * score_matrix(sp, state)
            + p[:, :, None] * q[:, None, :])


# ------------------------------------------------------------- cache updates


def _onehot(slot: torch.Tensor, r: int) -> torch.Tensor:
    return torch.arange(r, device=slot.device)[None, :] == slot[:, None]


def _cond_remove(state: MCMCState, slot: torch.Tensor,
                 pred: torch.Tensor) -> MCMCState:
    """Remove the item at ``slot`` of each chain where ``pred``: a rank-1
    inverse downdate."""
    minv = state.minv
    c, r = minv.shape[0], minv.shape[1]
    rows = _rows(c, minv.device)
    d = minv[rows, slot, slot]
    d = torch.where(pred & (d.abs() > _TINY), d, torch.ones_like(d))
    new = minv - (minv[rows, :, slot][:, :, None]
                  * minv[rows, slot, :][:, None, :]) / d[:, None, None]
    # row/col `slot` are ~0 after the downdate; pin them to the exact
    # identity padding so drift cannot accumulate there
    e = _onehot(slot, r)
    new = torch.where(e[:, :, None] | e[:, None, :], torch.zeros_like(new),
                      new)
    new[rows, slot, slot] = 1.0
    gone = e & pred[:, None]
    return MCMCState(
        items=torch.where(gone, torch.full_like(state.items, -1), state.items),
        mask=state.mask & ~gone,
        minv=torch.where(pred[:, None, None], new, minv),
        step=state.step)


def _cond_add(Z: msh.Rows, x: torch.Tensor, state: MCMCState,
              j: torch.Tensor, slot: torch.Tensor,
              pred: torch.Tensor) -> MCMCState:
    """Add item j at padding slot ``slot`` of each chain where ``pred``: a
    block-inverse update."""
    u, v, t = _uvt(Z, x, state, j)
    minv = state.minv
    r = minv.shape[1]
    pu = torch.einsum("cij,cj->ci", minv, u)
    vp = torch.einsum("ci,cij->cj", v, minv)
    delta = t - (v * pu).sum(-1)
    d = torch.where(pred & (delta.abs() > _TINY), delta,
                    torch.ones_like(delta))[:, None, None]
    e = _onehot(slot, r).to(minv.dtype)
    outer = lambda a, b: a[:, :, None] * b[:, None, :]  # noqa: E731
    new = (minv + (outer(pu, vp) - outer(pu, e) - outer(e, vp)) / d
           + (1.0 / d - 1.0) * outer(e, e))
    put = (e > 0) & pred[:, None]
    return MCMCState(
        items=torch.where(put, j[:, None].expand_as(state.items), state.items),
        mask=state.mask | put,
        minv=torch.where(pred[:, None, None], new, minv),
        step=state.step)


# ------------------------------------------------------------------ MH steps


class _Noise(NamedTuple):
    """Every random number of a call's steps, (C, T, ...) each."""

    u_move: torch.Tensor   # (C, T) move-kind coin
    cand: torch.Tensor     # (C, T) candidate item
    g_slot: torch.Tensor   # (C, T, R) Gumbel noise of the occupied-slot pick
    u_acc: torch.Tensor    # (C, T) acceptance coin


def _step_noise(chain_keys: torch.Tensor, steps: torch.Tensor, m: int,
                r: int) -> _Noise:
    """The reference's per-step draws: step t of chain c is keyed
    ``fold_in(chain_keys[c], steps[c, t])`` and split in four (move kind,
    candidate, slot, acceptance)."""
    keys = trandom.fold_in(chain_keys[:, None, :], steps)         # (C, T, 2)
    ks = trandom.split(keys, 4)                                 # (C, T, 4, 2)
    return _Noise(u_move=trandom.uniform(ks[..., 0, :]),
                  cand=trandom.randint(ks[..., 1, :], (), 0, m),
                  g_slot=trandom.gumbel(ks[..., 2, :], (r,)),
                  u_acc=trandom.uniform(ks[..., 3, :]))


def _mh_step(Z: msh.Rows, x: torch.Tensor, state: MCMCState,
             noise: _Noise, *, fixed: bool, p_swap: float
             ) -> Tuple[MCMCState, torch.Tensor]:
    """One Metropolis step of every chain, with this step's noise (C, ...).
    ``fixed=True`` is the k-NDPP swap chain; otherwise the up/down chain
    with a ``p_swap`` swap mixture.  Proposals are symmetric, so a move is
    accepted with probability min(1, det ratio).  Returns (new state,
    accepted (C,))."""
    items, mask, minv = state.items, state.mask, state.minv
    c, r = items.shape
    rows = _rows(c, items.device)
    size = mask.sum(dim=1)
    cand = noise.cand
    cand_hit = (items == cand[:, None]) & mask
    cand_in = cand_hit.any(dim=1)
    cand_slot = torch.argmax(cand_hit.to(torch.int8), dim=1)
    free_slot = torch.argmin(mask.to(torch.int8), dim=1)          # first pad
    full = size >= r
    # uniform occupied slot: categorical over where(mask, 0, -inf)
    logits = torch.where(mask, torch.zeros_like(noise.g_slot),
                         torch.full_like(noise.g_slot, -math.inf))
    occ_slot = torch.argmax(noise.g_slot + logits, dim=1)
    occ_slot = torch.where(size > 0, occ_slot, torch.zeros_like(occ_slot))

    u, v, t = _uvt(Z, x, state, cand)
    pu = torch.einsum("cij,cj->ci", minv, u)
    vp = torch.einsum("ci,cij->cj", v, minv)
    r_add = t - (v * pu).sum(-1)
    p_occ = minv[rows, occ_slot, occ_slot]
    r_swap = p_occ * r_add + vp[rows, occ_slot] * pu[rows, occ_slot]
    r_rem = minv[rows, cand_slot, cand_slot]

    if fixed:
        move_add = move_rem = torch.zeros_like(cand_in)
        move_swap = (~cand_in) & (size > 0)
    else:
        is_swap = noise.u_move < p_swap
        move_swap = is_swap & (~cand_in) & (size > 0)
        move_add = (~is_swap) & (~cand_in) & (~full)
        move_rem = (~is_swap) & cand_in

    zero = torch.zeros_like(r_add)
    ratio = torch.where(move_add, r_add, torch.where(
        move_rem, r_rem, torch.where(move_swap, r_swap, zero)))
    ratio = torch.where(torch.isfinite(ratio) & (ratio > 0), ratio, zero)
    # an accepted swap is a remove-then-add whose downdate divides by the
    # remove pivot; veto swaps whose pivot is at float-noise scale
    ratio = torch.where(move_swap & (p_occ.abs() < _PIVOT_EPS), zero, ratio)
    accept = noise.u_acc < torch.clamp(ratio, max=1.0)

    rem_slot = torch.where(move_rem, cand_slot, occ_slot)
    add_slot = torch.where(move_add, free_slot, occ_slot)
    state = _cond_remove(state, rem_slot, accept & (move_rem | move_swap))
    state = _cond_add(Z, x, state, cand, add_slot,
                      accept & (move_add | move_swap))
    return state._replace(step=state.step + 1), accept


def run_chains(sp: SpectralNDPP, chain_keys: torch.Tensor,
               states: MCMCState, *, n_steps: int, fixed: bool = False,
               p_swap: float = 0.25, refresh_every: int = 64):
    """Advance C chains ``n_steps`` MH steps.

    chain_keys: (C, 2); states: an ``MCMCState`` with leading dim C.
    Returns (states, items_trace (C, n_steps, R), mask_trace, accept_trace
    (C, n_steps)).  Step t of chain c is keyed ``fold_in(chain_keys[c],
    states.step[c] + t)``.  The cached inverse is recomputed exactly on the
    absolute-step schedule ``step % refresh_every == 0``, checked at block
    boundaries of ``refresh_every`` steps from the call's start, so calls
    whose sizes divide ``refresh_every`` reproduce a single call exactly.
    A row-sharded ``sp.Z`` (``run_chains_sharded``) is read through its
    owners; candidates are drawn over the global M either way.
    """
    Z = sp.Z
    x = sp.x_matrix()
    c, r = states.items.shape
    dev = sp.sigma.device
    chain_keys = trandom.as_key(chain_keys, dev)
    steps = states.step[:, None] + torch.arange(n_steps, device=dev)[None, :]
    noise = _step_noise(chain_keys, steps, Z.shape[0], r)
    items_tr = torch.empty((c, n_steps, r), dtype=torch.int64, device=dev)
    mask_tr = torch.empty((c, n_steps, r), dtype=torch.bool, device=dev)
    acc_tr = torch.empty((c, n_steps), dtype=torch.bool, device=dev)
    state = states
    for t in range(n_steps):
        if t % refresh_every == 0:
            hit = (state.step % refresh_every == 0)[:, None, None]
            ly = _padded_l(Z, x, state.items, state.mask)
            state = state._replace(minv=torch.where(hit, _inv(ly), state.minv))
        state, acc = _mh_step(Z, x, state, _Noise(*(f[:, t] for f in noise)),
                              fixed=fixed, p_swap=p_swap)
        items_tr[:, t] = state.items
        mask_tr[:, t] = state.mask
        acc_tr[:, t] = acc
    return state, items_tr, mask_tr, acc_tr


def run_chains_sharded(sp: SpectralNDPP, chain_keys: torch.Tensor,
                       states: MCMCState, *, mesh, n_steps: int,
                       fixed: bool = False, p_swap: float = 0.25,
                       refresh_every: int = 64):
    """``run_chains`` with the (M, 2K) catalog rows sharded over the mesh
    "model" axis (placed first unless they already are).  The chain states
    stay on the mesh's first device; only the candidate row z_j and the
    <= 2K subset rows cross shards, each from its owner by a psum of exact
    zeros, so the trajectories equal the unsharded ``run_chains``'s while
    each device holds M/S rows.  M must divide over the mesh."""
    s = msh.model_extent(mesh)
    m_total = sp.Z.shape[0]
    if m_total % s != 0:
        raise ValueError(
            f"the mesh 'model' extent {s} must divide the catalog size "
            f"M={m_total}; pad the catalog or use a smaller mesh")
    return run_chains(shard_spectral(sp, mesh), chain_keys.to(mesh.device),
                      MCMCState(*(a.to(mesh.device) for a in states)),
                      n_steps=n_steps, fixed=fixed, p_swap=p_swap,
                      refresh_every=refresh_every)


# --------------------------------------------------------------- greedy init


def _greedy_round(sp: SpectralNDPP, states: MCMCState,
                  chain_keys: torch.Tensor, round_idx: int) -> MCMCState:
    """One greedy round: score every candidate for every chain with the
    ``score_all`` kernel (on each shard's rows when Z is sharded) and add
    one item per chain with probability proportional to its positive
    determinant gain."""
    x = sp.x_matrix()
    m = sp.Z.shape[0]
    a = score_matrix(sp, states).contiguous()                     # (C, R, R)
    if isinstance(sp.Z, msh.ShardedRows):
        scores = mcmc_score_ops.score_all_sharded(sp.Z, a, sp.Z.mesh)
    else:
        scores = mcmc_score_ops.score_all(sp.Z, a)                # (C, M)
    # taken items are excluded (-inf), not floored: a floored logit could
    # re-pick a held item and wedge the chain on a duplicate id
    held = torch.where(states.mask, states.items,
                       torch.full_like(states.items, m))
    taken = torch.zeros((scores.shape[0], m + 1), dtype=torch.bool,
                        device=scores.device)
    taken[_rows(held.shape[0], held.device)[:, None], held] = True
    logits = torch.where(taken[:, :m], torch.full_like(scores, -math.inf),
                         torch.log(scores.clamp_min(0.0).clamp_min(_TINY)))
    picks = trandom.categorical(trandom.fold_in(chain_keys, round_idx), logits)
    free = torch.argmin(states.mask.to(torch.int8), dim=1)
    return _cond_add(sp.Z, x, states, picks, free,
                     torch.ones_like(states.mask[:, 0]))


def init_greedy(sp: SpectralNDPP, key, n_chains: int, k: int) -> MCMCState:
    """Stochastic-greedy size-k starts for C = ``n_chains`` chains, each a
    distinct size-k subset with det(L_Y) > 0 and a freshly inverted cache.
    Round i of chain c draws from ``fold_in(split(key, C)[c], i)``."""
    chain_keys = trandom.split(trandom.as_key(key, sp.sigma.device), n_chains)
    states = init_empty(sp, n_chains)
    for i in range(k):
        states = _greedy_round(sp, states, chain_keys, i)
    return refresh(sp, states)


# ------------------------------------------------------------------ sampling


def sample_mcmc(
    sp: SpectralNDPP, key, n_samples: int, *, k: Optional[int] = None,
    n_chains: int = 64, burn_in: int = 512, thin: int = 8,
    p_swap: float = 0.25, refresh_every: int = 64, mesh=None, observer=None,
) -> MCMCSample:
    """Draw ``n_samples`` subsets by MCMC (target Pr(Y) ∝ det(L_Y)).

    ``k=None`` runs the up/down chain from Y = ∅; an integer ``k`` runs the
    fixed-size swap chain from stochastic-greedy size-k starts.  Each of
    ``n_chains`` chains contributes ``ceil(n_samples / n_chains)`` states
    taken every ``thin`` steps after ``burn_in``.  ``mesh``: keep the
    catalog rows on their shards (``run_chains_sharded``), with the same
    draws.  ``observer``: a duck-typed telemetry sink
    (``repro_torch.obs.RegistryObserver``) that gets one
    ``on_mcmc(steps=, n_chains=, accept_fraction=)`` call with host
    numbers read off the acceptance trace the chains already return (one
    scalar copy to the host; the draws are untouched).
    """
    dev = sp.sigma.device
    key = trandom.as_key(key, dev)
    n_chains = min(n_chains, n_samples)
    per_chain = -(-n_samples // n_chains)
    n_steps = burn_in + thin * per_chain
    chain_keys = trandom.split(key, n_chains)
    if k is None:
        states = init_empty(sp, n_chains)
    else:
        states = init_greedy(sp, trandom.fold_in(key, 0x6d636d63), n_chains,
                             k)
    if mesh is None:
        _, items_tr, mask_tr, acc_tr = run_chains(
            sp, chain_keys, states, n_steps=n_steps, fixed=k is not None,
            p_swap=p_swap, refresh_every=refresh_every)
    else:
        _, items_tr, mask_tr, acc_tr = run_chains_sharded(
            sp, chain_keys, states, mesh=mesh, n_steps=n_steps,
            fixed=k is not None, p_swap=p_swap, refresh_every=refresh_every)
        dev = mesh.device
    accept_rate = acc_tr.float().mean()
    if observer is not None:
        observer.on_mcmc(steps=n_steps * n_chains, n_chains=n_chains,
                         accept_fraction=float(accept_rate))
    take = burn_in + thin * np.arange(1, per_chain + 1) - 1
    take_t = torch.as_tensor(take, device=dev)
    r = items_tr.shape[-1]
    items = items_tr[:, take_t].reshape(-1, r)[:n_samples]
    mask = mask_tr[:, take_t].reshape(-1, r)[:n_samples]
    steps = (take_t + 1).repeat(n_chains)[:n_samples]
    return MCMCSample(items=items, mask=mask, steps=steps,
                      accept_rate=accept_rate)
