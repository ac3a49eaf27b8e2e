"""Rejection NDPP sampling (Section 4, Algorithm 2); port of
``repro/core/rejection.py``.

Target:   Pr_L(Y)    ∝ det(L_Y),      L    = Z X Z^T (nonsymmetric)
Proposal: Pr_Lhat(Y) ∝ det(Lhat_Y),   Lhat = Z Xhat Z^T (symmetric PSD)

Theorem 1 gives det(L_Y) <= det(Lhat_Y), so a proposal is accepted with
probability det(L_Y) / det(Lhat_Y) and the expected number of trials is
det(Lhat + I) / det(L + I); for ONDPP kernels (V ⟂ B) that equals
prod_j (1 + 2 sigma_j / (sigma_j^2 + 1)) (Theorem 2), independent of M.

Speculative rounds: every pending request contributes ``n_spec`` i.i.d.
proposals to one batched tree traversal and one batched log-det ratio, and
retires at its first acceptance.  Proposal t of a request is always keyed
``fold_in(request_key, t)``, so draws, trial counts and accept flags do not
depend on how proposals were batched — they equal the reference's, key for
key.  The observed driver ``drive_rounds`` grows the round width after a
missed round and reports each round and retirement to a duck-typed
observer; the sequential ``sample`` / ``sample_batch`` run trial t of every
pending request as one batched round.

Item-axis sharding (``shard_sampler``, ``sample_batched_many(mesh=)``):
the tree's deep levels and W and the Z rows live split over a mesh, and
each round runs the descent, the leaf scoring and the Z-row gathers of
the log-det ratio on the shards owning the rows, combined by psums of
exact zeros (``models.sharding``).  Draws, trial counts and accept flags
equal the unsharded sampler's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import random as trandom
from ..device import DeviceLike, resolve_device
from ..models import sharding as msh
from .tree import (
    AnyTree,
    construct_tree,
    proposal_eigens,
    sample_proposal_dpp_batch,
    shard_spectral,
    shard_tree,
)
from .types import SpectralNDPP

#: shared no-op context for drivers whose observer has no ``phase`` hook
_NO_PHASE = contextlib.nullcontext()


class RejectionSample(NamedTuple):
    items: torch.Tensor     # (..., R) padded item indices (-1 = empty slot)
    mask: torch.Tensor      # (..., R) validity mask
    trials: torch.Tensor    # proposals drawn (>= 1)
    accepted: torch.Tensor  # bool; False => max_trials exhausted


@dataclasses.dataclass(frozen=True)
class NDPPSampler:
    """Preprocessed state for repeated sublinear-time sampling: the
    spectral form and the proposal tree, on one device or, after
    ``shard_sampler``, on a mesh."""

    sp: SpectralNDPP
    tree: AnyTree

    @property
    def M(self) -> int:
        return self.sp.M

    @property
    def device(self) -> torch.device:
        return self.tree.device


def preprocess(V, B, D, block: int = 64, *, device: DeviceLike = None
               ) -> NDPPSampler:
    """PREPROCESS of Algorithm 2 (+ the tree of Algorithm 3) on ``device``
    (default ``cuda``): Youla decomposition on the host in float64, then
    the proposal eigens and the tree on the device."""
    from .youla import spectral_from_params

    sp = spectral_from_params(V, B, D, device=resolve_device(device))
    lam, w = proposal_eigens(sp)
    tree = construct_tree(lam, w, block=block)
    return NDPPSampler(sp=sp, tree=tree)


def _log_det_ratio_rows(sp: SpectralNDPP, zy: torch.Tensor,
                        mask: torch.Tensor,
                        live_rows: Optional[torch.Tensor] = None,
                        live_x: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """log det(L_Y) - log det(Lhat_Y) and sign det(L_Y) from gathered
    (..., k_pad, 2K) subset rows with padding rows zeroed; padding rows get
    a unit diagonal so they contribute a factor of exactly 1.
    ``live_rows``/``live_x``: pre-gathered numerator overrides (see
    ``log_det_ratio``)."""
    x = sp.x_matrix() if live_x is None else live_x
    num = zy if live_rows is None else live_rows
    pad_eye = torch.diag_embed((~mask).to(zy.dtype))
    l_y = num @ x @ num.transpose(-1, -2) + pad_eye
    lhat_y = (zy * sp.x_diag_hat()) @ zy.transpose(-1, -2) + pad_eye
    sign_l, logdet_l = torch.linalg.slogdet(l_y)
    sign_h, logdet_h = torch.linalg.slogdet(lhat_y)
    good = (sign_l > 0) & (sign_h > 0)
    return (torch.where(good, logdet_l - logdet_h,
                        torch.full_like(logdet_l, -math.inf)), sign_l)


def log_det_ratio(sp: SpectralNDPP, items: torch.Tensor, mask: torch.Tensor,
                  live_z: Optional[torch.Tensor] = None,
                  live_x: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log det(L_Y) - log det(Lhat_Y), sign of det(L_Y)) for padded
    subsets: items/mask (..., k_pad); leading dims are a batch.

    ``live_z`` / ``live_x`` override the numerator only: the acceptance
    test then scores the live kernel ``live_z X_live live_z^T`` while the
    denominator stays the proposal Lhat that ``sp`` sampled from — the
    stale-proposal acceptance of the dynamic catalog.  A live row zeroed by
    a delete makes sign(det L_Y) = 0, so deleted items are always rejected.
    """
    zy = msh.gather_rows(sp.Z, items, mask)
    live_rows = (None if live_z is None
                 else msh.gather_rows(live_z, items, mask))
    return _log_det_ratio_rows(sp, zy, mask, live_rows=live_rows,
                               live_x=live_x)


def log_det_ratio_batch(sp: SpectralNDPP, items: torch.Tensor,
                        mask: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``log_det_ratio`` over N padded subsets (N, k_pad) with one batched
    slogdet per kernel."""
    return log_det_ratio(sp, items, mask)


def expected_trials(sp: SpectralNDPP) -> torch.Tensor:
    """Theorem 2 (requires V ⟂ B): prod_j (1 + 2 sigma_j/(sigma_j^2+1))."""
    s = sp.sigma
    return torch.prod(1.0 + 2.0 * s / (s ** 2 + 1.0))


def det_ratio_exact(sp: SpectralNDPP) -> torch.Tensor:
    """det(Lhat + I) / det(L + I) without the orthogonality assumption, via
    2K x 2K determinants (det(I + Z A Z^T) = det(I + A Z^T Z)); a sharded
    Z is gathered first."""
    z = msh.full_rows(sp.Z)
    g = z.T @ z
    eye = torch.eye(g.shape[0], dtype=g.dtype, device=g.device)
    _, ld_l = torch.linalg.slogdet(eye + sp.x_matrix() @ g)
    _, ld_h = torch.linalg.slogdet(eye + sp.x_diag_hat()[:, None] * g)
    return torch.exp(ld_h - ld_l)


def _sample_lanes(sampler: NDPPSampler, keys: torch.Tensor,
                  propose: Callable, max_trials: int) -> RejectionSample:
    """The sequential SAMPLEREJECT loop of N requests (keys (N, 2)) at once:
    trial t of every request is one batched round, ``kk, k_prop, k_acc =
    split(kk, 3)`` then ``propose(k_prop)`` -> (items, mask) (N, R), one
    batched log-det ratio and ``log(uniform(k_acc)) <= log_ratio``.  A
    retired request rides along masked: its result stays as it was.  The
    host reads one flag a round: whether every request has accepted.  A
    request that exhausts ``max_trials`` returns its last proposal with
    ``accepted=False``."""
    n, r = keys.shape[0], sampler.tree.R
    dev = keys.device
    items = torch.full((n, r), -1, dtype=torch.int64, device=dev)
    mask = torch.zeros((n, r), dtype=torch.bool, device=dev)
    trials = torch.zeros(n, dtype=torch.int64, device=dev)
    accepted = torch.zeros(n, dtype=torch.bool, device=dev)
    kk = keys
    for _ in range(max_trials):
        ks = trandom.split(kk, 3)                                 # (N, 3, 2)
        kk = ks[:, 0]
        it, mk = propose(ks[:, 1])
        log_ratio, _ = log_det_ratio_batch(sampler.sp, it, mk)
        accept = torch.log(trandom.uniform(ks[:, 2])) <= log_ratio
        pend = ~accepted
        items = torch.where(pend[:, None], it, items)
        mask = torch.where(pend[:, None], mk, mask)
        trials = trials + pend.long()
        accepted = accepted | (pend & accept)
        if bool(accepted.all()):
            break
    return RejectionSample(items=items, mask=mask, trials=trials,
                           accepted=accepted)


def _proposals(sampler: NDPPSampler) -> Callable:
    return lambda ks: sample_proposal_dpp_batch(sampler.tree, ks)


def sample(sampler: NDPPSampler, key, max_trials: int = 1000
           ) -> RejectionSample:
    """SAMPLEREJECT of Algorithm 2 for one key (2,): draw from DPP(Lhat)
    through the tree, accept with probability det(L_Y)/det(Lhat_Y), until
    an acceptance or ``max_trials`` proposals."""
    key = trandom.as_key(key, sampler.device)
    res = _sample_lanes(sampler, key[None], _proposals(sampler), max_trials)
    return RejectionSample(*(x[0] for x in res))


def sample_batch(sampler: NDPPSampler, key, n: int,
                 max_trials: int = 1000) -> RejectionSample:
    """``sample`` for each of ``split(key, n)``, as ``vmap(sample)``: the n
    requests' trial t runs as one batched round.  Leading dim n."""
    keys = trandom.split(trandom.as_key(key, sampler.device), n)
    return _sample_lanes(sampler, keys, _proposals(sampler), max_trials)


def _spec_round_impl(sampler: NDPPSampler, keys: torch.Tensor):
    """One speculative round: one proposal per key (N, 2) through the
    batched tree traversal, one batched log-det ratio, one acceptance coin
    each.  Returns (items, mask, accept) with leading dim N."""
    ks = trandom.split(keys)                                      # (N, 2, 2)
    items, mask = sample_proposal_dpp_batch(sampler.tree, ks[:, 0])
    log_ratio, _ = log_det_ratio_batch(sampler.sp, items, mask)
    u = trandom.uniform(ks[:, 1])
    accept = torch.log(u) <= log_ratio
    return items, mask, accept


def _fanout_traced(req_keys: torch.Tensor, starts: torch.Tensor,
                   offsets: torch.Tensor) -> torch.Tensor:
    """Key of proposal t of request i: fold_in(req_keys[i], starts[i] + t)
    for t in ``offsets``.  Returns (P * S, 2), request-major.  The
    reference's ``_fanout_keys`` too, which only jits this function."""
    data = starts[:, None] + offsets[None, :]                     # (P, S)
    keys = trandom.fold_in(req_keys[:, None, :], data)            # (P, S, 2)
    return keys.reshape(-1, 2)



def _spec_round_fused(sampler: NDPPSampler, slot_keys: torch.Tensor,
                      trials: torch.Tensor, *, n_spec: int):
    """One engine tick's round: proposal t of slot i is keyed
    ``fold_in(slot_keys[i], trials[i] + t)`` for t < n_spec.  Returns
    (items, mask, accept) with leading dim n * n_spec."""
    offsets = torch.arange(n_spec, dtype=torch.int64, device=slot_keys.device)
    keys = _fanout_traced(slot_keys, trials, offsets)
    return _spec_round_impl(sampler, keys)


def shard_sampler(sampler: NDPPSampler, mesh) -> NDPPSampler:
    """Place a preprocessed sampler on a mesh: the tree's deep levels and
    W and the Z rows item-sharded over the "model" axis (shallow levels,
    lam and sigma replicated); a sampler already on ``mesh`` keeps its
    arrays.  The placed sampler draws the same samples through the same
    entry points (``_spec_round_impl``, ``sample_batched_many``): its
    descent, leaf scoring and Z-row gathers run on the shards owning the
    rows, combined by psums of exact zeros on the mesh's first device.
    """
    return NDPPSampler(sp=shard_spectral(sampler.sp, mesh),
                       tree=shard_tree(sampler.tree, mesh))


def auto_n_spec(sampler: NDPPSampler, max_spec: int = 64) -> int:
    """Speculation depth that accepts most requests in one round: the next
    power of two >= E[#trials] = det(Lhat+I)/det(L+I), capped at max_spec."""
    expect = float(det_ratio_exact(sampler.sp))
    return int(min(max_spec, max(2, 1 << int(math.ceil(
        math.log2(max(1.0, expect)))))))


def sample_batched(
    sampler: NDPPSampler, key, n_spec: Optional[int] = None,
    max_trials: int = 1000, grow: int = 2, max_spec: int = 64, mesh=None,
) -> RejectionSample:
    """Speculative SAMPLEREJECT for one request key (2,): each round draws
    ``n_spec`` proposals at once and accepts the first success.  The same
    draw as ``sample`` with the same key schedule as
    ``sample_batched_many`` (row 0 of it on ``key[None]``)."""
    res = sample_batched_many(
        sampler, trandom.as_key(key)[None], n_spec=n_spec,
        max_trials=max_trials, grow=grow, max_spec=max_spec,
        split_keys=False, mesh=mesh)
    return RejectionSample(*(x[0] for x in res))


def sample_batched_many(
    sampler: NDPPSampler, key, n: Optional[int] = None,
    n_spec: Optional[int] = None, max_trials: int = 1000, grow: int = 2,
    max_spec: int = 64, split_keys: bool = True, mesh=None, observer=None,
) -> RejectionSample:
    """Speculative rejection sampling for many requests sharing each round.

    ``key``: a single key (``split_keys=True``, split into ``n`` request
    keys) or an (n, 2) array of per-request keys.  ``n_spec=None``
    auto-sizes the rounds to ~E[#trials] (``auto_n_spec``).  Rounds keep a
    constant width of ``n * n_spec`` lanes (``_drive_rounds_fused``), as
    on the reference's default path.  ``mesh``: run every round
    item-sharded over the mesh "model" axis (``shard_sampler``, then the
    same rounds; pass its output to place the arrays once); the results
    equal the unsharded path's.  ``observer``: a duck-typed telemetry sink
    (see ``drive_rounds``), which runs the rounds through the observed
    driver instead, with the round width multiplied by ``grow`` (capped at
    ``max_spec``) after a missed round; the results are the same.
    Returns a stacked RejectionSample with leading dim n, on the sampler's
    (first) device.
    """
    if mesh is not None:
        sampler = shard_sampler(sampler, mesh)
    dev = sampler.device
    if n_spec is None:
        n_spec = auto_n_spec(sampler, max_spec)
    key = trandom.as_key(key, dev)
    if split_keys:
        if n is None:
            raise ValueError("n is required when passing a single key")
        req_keys = trandom.split(key, n)
    else:
        req_keys = key

    def round_fn(keys):
        return _spec_round_impl(sampler, keys)

    if observer is None:
        return _drive_rounds_fused(round_fn, req_keys, sampler.tree.R,
                                   n_spec=n_spec, max_trials=max_trials)
    return drive_rounds(round_fn, req_keys, sampler.tree.R, n_spec=n_spec,
                        max_trials=max_trials, grow=grow, max_spec=max_spec,
                        observer=observer)


def _drive_rounds_fused(round_fn: Callable, req_keys: torch.Tensor, r: int,
                        *, n_spec: int, max_trials: int) -> RejectionSample:
    """The speculative accept/reject loop (the reference's one-jit driver),
    shared with the dynamic-catalog sampler
    (``core.dynamic.sample_dynamic_many``).

    ``round_fn(keys)`` scores one proposal per (P, 2) key and returns
    (items, mask, accept) with up to ``r`` items each.  Round t covers
    proposal offsets ``[t*n_spec, (t+1)*n_spec)`` of every request, keyed
    ``fold_in(req_keys[i], offset)``; lanes past
    ``max_trials`` are masked, never reshaped away, and retired requests
    ride along as masked lanes, so every round has the same width and a
    later port can capture it as a CUDA graph.  The host reads one flag
    per round: whether every request has accepted.  Exhausted requests
    return their last in-budget proposal with ``accepted=False`` and
    ``trials=max_trials``.
    """
    n = req_keys.shape[0]
    dev = req_keys.device
    offsets = torch.arange(n_spec, dtype=torch.int64, device=dev)
    lane = torch.arange(n_spec, device=dev)
    items = torch.full((n, r), -1, dtype=torch.int64, device=dev)
    mask = torch.zeros((n, r), dtype=torch.bool, device=dev)
    trials = torch.zeros(n, dtype=torch.int64, device=dev)
    accepted = torch.zeros(n, dtype=torch.bool, device=dev)
    spent = 0
    while spent < max_trials:
        starts = torch.full((n,), spent, dtype=torch.int64, device=dev)
        keys = _fanout_traced(req_keys, starts, offsets)
        it, mk, ac = round_fn(keys)
        it = it.reshape(n, n_spec, r)
        mk = mk.reshape(n, n_spec, r)
        usable = min(n_spec, max_trials - spent)
        ac = ac.reshape(n, n_spec) & (lane[None, :] < usable)
        any_acc = ac.any(dim=1)
        first = torch.argmax(ac.to(torch.int8), dim=1)
        pend = ~accepted
        newly = pend & any_acc
        # first accepted lane, else the last in-budget lane (the exhaustion
        # payout)
        pick = torch.where(any_acc, first, torch.full_like(first, usable - 1))
        rows = torch.arange(n, device=dev)
        items = torch.where(pend[:, None], it[rows, pick], items)
        mask = torch.where(pend[:, None], mk[rows, pick], mask)
        trials = torch.where(newly, spent + first + 1, trials)
        accepted = accepted | newly
        spent += usable
        if bool(accepted.all()):
            break
    trials = torch.where(accepted, trials,
                         torch.full_like(trials, max_trials))
    return RejectionSample(items=items, mask=mask, trials=trials,
                           accepted=accepted)


def drive_rounds(round_fn: Callable, req_keys: torch.Tensor, r: int, *,
                 n_spec: int, max_trials: int = 1000, grow: int = 2,
                 max_spec: int = 64, observer=None) -> RejectionSample:
    """The reference's observed speculative-round driver: a host loop over
    the still-pending requests, padded to a power of two, whose round
    width starts at ``n_spec`` and is multiplied by ``grow`` (capped at
    ``max_spec``) after each round.  ``round_fn(keys)`` scores one
    proposal per (P, 2) key and returns (items, mask, accept).  Proposal t
    of request i is keyed ``fold_in(req_keys[i], t)``, so the results equal
    ``_drive_rounds_fused``'s under any schedule.

    ``observer``: optional duck-typed sink.  After each round's one
    device-to-host read it gets ``on_round(n_active=, n_spec=, proposals=,
    accepts=)`` and one ``on_retire(trials=, accepted=)`` per request
    leaving the pending set, all plain host ints; an optional
    ``phase(name)`` context manager names the "round_dispatch" and
    "harvest" ranges.  Observation adds no sync and cannot change a draw.
    """
    phase = getattr(observer, "phase", None) or (lambda name: _NO_PHASE)
    n = req_keys.shape[0]
    dev = req_keys.device
    items_out = np.full((n, r), -1, np.int64)
    mask_out = np.zeros((n, r), bool)
    trials_out = np.zeros((n,), np.int64)
    acc_out = np.zeros((n,), bool)

    active = np.arange(n)
    spent = 0                      # the same for every pending request
    cur = int(n_spec)
    while active.size:
        cur = min(cur, max_spec)
        # budget truncation by masking: the round keeps its width and only
        # the first ``usable`` lanes (offsets [spent, spent + usable)) count
        usable = min(cur, max_trials - spent)
        n_act = int(active.size)
        n_pad = 1 << max(0, n_act - 1).bit_length()
        # pad with repeats of the first request; their results are dropped
        rows = np.concatenate([active, np.full(n_pad - n_act, active[0])])
        act_keys = req_keys[torch.as_tensor(rows, device=dev)]
        with phase("round_dispatch"):
            keys = _fanout_traced(
                act_keys, torch.full((n_pad,), spent, dtype=torch.int64,
                                     device=dev),
                torch.arange(cur, dtype=torch.int64, device=dev))
            items, mask, accept = round_fn(keys)
        with phase("harvest"):
            items_h, mask_h, acc = (x.cpu().numpy()
                                    for x in (items, mask, accept))
        acc = acc.reshape(n_pad, cur)[:n_act, :usable]
        items_h = items_h.reshape(n_pad, cur, r)[:n_act]
        mask_h = mask_h.reshape(n_pad, cur, r)[:n_act]

        any_acc = acc.any(axis=1)
        first = acc.argmax(axis=1)
        hit = active[any_acc]
        items_out[hit] = items_h[any_acc, first[any_acc]]
        mask_out[hit] = mask_h[any_acc, first[any_acc]]
        trials_out[hit] = spent + first[any_acc] + 1
        acc_out[hit] = True
        if observer is not None:
            observer.on_round(n_active=n_act, n_spec=usable,
                              proposals=n_act * usable, accepts=int(acc.sum()))
            for t in trials_out[hit]:
                observer.on_retire(trials=int(t), accepted=True)

        spent += usable
        miss = ~any_acc
        if spent >= max_trials:    # exhausted: the last in-budget proposal
            left = active[miss]
            items_out[left] = items_h[miss, usable - 1]
            mask_out[left] = mask_h[miss, usable - 1]
            trials_out[left] = spent
            if observer is not None:
                for _ in left:
                    observer.on_retire(trials=spent, accepted=False)
            break
        active = active[miss]
        cur *= grow

    return RejectionSample(*(torch.as_tensor(a, device=dev) for a in
                             (items_out, mask_out, trials_out, acc_out)))
