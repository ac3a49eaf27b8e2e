"""Minibatch trainer for (O)NDPP basket models (Eq. 14); port of
``repro/train/ndpp.py``.

The learning half of the paper's pipeline: fit an ONDPP (or the
unconstrained NDPP baseline) on observed baskets, then export the learned
kernel through the Youla/spectral path into the sampling stack, the same
``SpectralNDPP`` / ``NDPPSampler`` / ``Catalog`` objects every sampler and
the ``SamplerEngine`` take.

Each step draws a minibatch with replacement, its indices
``randint(fold_in(data_key, step), (minibatch,), 0, n)`` as the
reference's (so the schedule is the reference's index for index and does
not depend on ``scan_chunk``), takes one AdamW step on the objective with
gradients from ``torch.autograd`` and, for the ONDPP, projects onto the
constraint set (``B^T B = I``, ``V^T B = 0``, ``sigma >= 0``), so every
iterate obeys the Theorem 2 rejection-rate bound.  The reference fuses
``scan_chunk`` steps into one ``lax.scan``; here ``scan_chunk`` is the
cadence at which the chunk's losses come to the host (one transfer a
chunk) and logging runs.  Checkpoint and restart
(``train/checkpoint.py``) come with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from .. import random as trandom
from ..core.learning import (
    Baskets,
    init_ndpp,
    init_ondpp,
    item_frequencies,
    ndpp_loss,
    ondpp_loss,
    project_constraints,
)
from ..core.types import NDPPParams, ONDPPParams
from ..device import DeviceLike, resolve_device
from .optimizer import OptimizerConfig, make_optimizer

Params = Union[NDPPParams, ONDPPParams]


@dataclasses.dataclass(frozen=True)
class BasketTrainConfig:
    """Hyperparameters for basket-data (O)NDPP training.

    steps: optimizer steps; minibatch: baskets a step (None: the full batch
    every step); lr / optimizer / grad_clip: passed to ``train.optimizer``;
    alpha, beta: the inverse-popularity L2 weights (Eq. 14); gamma: the
    ONDPP log-rejection weight, which trades predictive quality against
    E[#trials] (the unconstrained baseline ignores it); seed: the init and
    minibatch-schedule key; scan_chunk: steps between the losses' trips
    to the host; log_every: log cadence in steps (0: silent), rounded up
    to chunk ends; checkpoint_dir / checkpoint_every: not ported yet.
    """

    steps: int = 1000
    minibatch: Optional[int] = None
    lr: float = 0.05
    optimizer: str = "adamw"
    grad_clip: float = 0.0
    alpha: float = 0.01
    beta: float = 0.01
    gamma: float = 0.1
    seed: int = 0
    scan_chunk: int = 250
    log_every: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0


@dataclasses.dataclass
class BasketTrainResult:
    """Outcome of a ``fit_*`` run: ``losses`` holds each step's minibatch
    objective at its pre-update parameters; ``loss_init`` / ``loss_final``
    are the full-batch objective at the (projected) init and at the final
    parameters, so ``improvement`` compares like with like."""

    params: Params
    losses: np.ndarray
    loss_init: float
    loss_final: float
    step: int

    @property
    def improvement(self) -> float:
        """Fractional loss improvement over init (0.25 = 25% lower)."""
        denom = max(abs(self.loss_init), 1e-12)
        return (self.loss_init - self.loss_final) / denom


def _chunk_bounds(start: int, stop: int, chunk: int
                  ) -> Iterator[Tuple[int, int]]:
    """[start, stop) split into [lo, hi) segments of at most ``chunk``."""
    lo = start
    while lo < stop:
        hi = min(lo + chunk, stop)
        yield lo, hi
        lo = hi


def fit_keys(seed: int, device: DeviceLike = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(init_key, data_key) of a fit with ``seed``:
    ``split(PRNGKey(seed))``."""
    k = trandom.split(trandom.PRNGKey(seed, device=device))
    return k[0], k[1]


def minibatch_indices(data_key: torch.Tensor, step: int, minibatch: int,
                      n: int) -> torch.Tensor:
    """Step ``step``'s minibatch, drawn with replacement:
    ``randint(fold_in(data_key, step), (minibatch,), 0, n)``."""
    return trandom.randint(trandom.fold_in(data_key, step), (minibatch,), 0, n)


_FIELDS = {"ondpp": ("V", "B", "sigma"), "ndpp": ("V", "B", "D")}
_KINDS = {"ondpp": ONDPPParams, "ndpp": NDPPParams}


def _fit(kind: str, baskets: Baskets, m: int, k: int, cfg: BasketTrainConfig,
         init_params: Optional[Params],
         log_fn: Optional[Callable[[str], None]]) -> BasketTrainResult:
    if cfg.checkpoint_dir is not None:
        raise NotImplementedError(
            "checkpoint/restart (train/checkpoint.py) comes with a later "
            "slice; see ROADMAP.md, Queue 1 item 8.3")
    if kind not in _FIELDS:
        raise ValueError(f"unknown kind {kind!r}")
    n = int(baskets.items.shape[0])
    if cfg.minibatch is not None and not 0 < cfg.minibatch:
        raise ValueError(f"minibatch must be positive, got {cfg.minibatch}")
    dev = baskets.items.device
    freq = item_frequencies(baskets, m)
    init_key, data_key = fit_keys(cfg.seed, dev)
    if kind == "ondpp":
        def loss_fn(p, mb):
            return ondpp_loss(p, mb, freq, alpha=cfg.alpha, beta=cfg.beta,
                              gamma=cfg.gamma)
        project = project_constraints
        params = init_params if init_params is not None \
            else init_ondpp(init_key, m, k, device=dev)
    else:
        def loss_fn(p, mb):
            return ndpp_loss(p, mb, freq, alpha=cfg.alpha, beta=cfg.beta)
        project = None
        params = init_params if init_params is not None \
            else init_ndpp(init_key, m, k, device=dev)
    fields, make = _FIELDS[kind], _KINDS[kind]
    with torch.no_grad():
        if init_params is not None and project is not None:
            # an explicit ONDPP init may violate the constraints: project it,
            # so that loss_init is the projected init's (init_ondpp's output
            # is projected already)
            params = project(params)
        leaves: Dict[str, torch.Tensor] = {
            f: getattr(params, f).detach().to(dev, torch.float32).clone()
            for f in fields}
        loss_init = float(loss_fn(make(**leaves), baskets))
    for t in leaves.values():
        t.requires_grad_(True)
    opt = make_optimizer(OptimizerConfig(name=cfg.optimizer, lr=cfg.lr,
                                         grad_clip=cfg.grad_clip))
    opt_state = opt.init(leaves)

    losses = []
    for lo, hi in _chunk_bounds(0, cfg.steps, cfg.scan_chunk):
        chunk = []
        for step in range(lo, hi):
            if cfg.minibatch is None:
                mb = baskets
            else:
                idx = minibatch_indices(data_key, step, cfg.minibatch, n)
                mb = Baskets(baskets.items[idx], baskets.mask[idx])
            loss = loss_fn(make(**leaves), mb)
            grads = torch.autograd.grad(loss, [leaves[f] for f in fields])
            opt.update(dict(zip(fields, grads)), opt_state, leaves)
            if project is not None:
                with torch.no_grad():
                    projected = project(make(**leaves))
                    for f in fields:
                        leaves[f].copy_(getattr(projected, f))
            chunk.append(loss.detach())
        ls = torch.stack(chunk).cpu().numpy()
        losses.extend(ls.tolist())
        if log_fn and cfg.log_every and (
                hi % cfg.log_every < cfg.scan_chunk or hi == cfg.steps):
            log_fn(f"[ndpp-trainer] step {hi} loss {float(ls[-1]):.4f}")
    params = make(**{f: t.detach() for f, t in leaves.items()})
    with torch.no_grad():
        loss_final = float(loss_fn(params, baskets))
    return BasketTrainResult(params=params,
                             losses=np.asarray(losses, np.float64),
                             loss_init=loss_init, loss_final=loss_final,
                             step=cfg.steps)


def fit_ondpp(baskets: Baskets, m: int, k: int,
              cfg: BasketTrainConfig = BasketTrainConfig(),
              init_params: Optional[ONDPPParams] = None,
              log_fn: Optional[Callable[[str], None]] = None
              ) -> BasketTrainResult:
    """Fit an orthogonality-constrained NDPP (Section 5) on baskets, on the
    baskets' device.  Every iterate satisfies the constraints, so the
    exported kernel's E[#trials] obeys the Theorem 2 product, and hence
    the rank-only bound ``2^(K/2)``, at any stopping point."""
    return _fit("ondpp", baskets, m, k, cfg, init_params, log_fn)


def fit_ndpp(baskets: Baskets, m: int, k: int,
             cfg: BasketTrainConfig = BasketTrainConfig(),
             init_params: Optional[NDPPParams] = None,
             log_fn: Optional[Callable[[str], None]] = None
             ) -> BasketTrainResult:
    """Fit the unconstrained NDPP baseline (Gartrell et al. 2021), whose
    rejection rate nothing bounds."""
    return _fit("ndpp", baskets, m, k, cfg, init_params, log_fn)


def moment_init_hothead(baskets: Baskets, m: int, k: int, n_pairs: int,
                        *, device: DeviceLike = None) -> NDPPParams:
    """Method-of-moments NDPP estimator for head/companion basket data
    (``data.baskets.hothead_baskets``: item ``2q`` is pair q's head,
    ``2q + 1`` its companion, the rest independent noise), on ``device``
    (default: the baskets').

    Per pair the three co-occurrence rates pin the 2 x 2 kernel block
    ``[[a, s], [-s, 0]]``: ``a = P(head only)/P(neither)`` and
    ``s^2 = P(both)/P(neither)``.  Noise items get independent diagonals
    ``p/(1 - p)``.  Used to initialise ``fit_ndpp`` in the basin whose
    expected trials pass the ONDPP rank bound."""
    if k < 2 * n_pairs:
        raise ValueError(f"need k >= 2*n_pairs, got k={k}, n_pairs={n_pairs}")
    dev = baskets.items.device if device is None else resolve_device(device)
    items = baskets.items.cpu().numpy()
    mask = baskets.mask.cpu().numpy().astype(bool)
    n = items.shape[0]
    present = np.zeros((n, m), bool)
    for r in range(n):
        present[r, items[r][mask[r]]] = True
    floor = 1.0 / n  # unobserved cells get a pseudo-count, not a div-by-0
    V = np.zeros((m, k), np.float64)
    B = np.zeros((m, k), np.float64)
    D = np.zeros((k, k), np.float64)
    for q in range(n_pairs):
        h, v = present[:, 2 * q], present[:, 2 * q + 1]
        p00 = max((~h & ~v).mean(), floor)
        p10 = max((h & ~v).mean(), floor)
        p11 = max((h & v).mean(), floor)
        V[2 * q, q] = np.sqrt(p10 / p00)
        B[2 * q, 2 * q] = 1.0
        B[2 * q + 1, 2 * q + 1] = 1.0
        D[2 * q, 2 * q + 1] = np.sqrt(p11 / p00)
    # noise items round-robin over the leftover symmetric dims
    free = list(range(n_pairs, k))
    if free:
        for j, i in enumerate(range(2 * n_pairs, m)):
            p = min(max(present[:, i].mean(), floor), 1.0 - floor)
            V[i, free[j % len(free)]] = np.sqrt(p / (1.0 - p))
    return NDPPParams(*(torch.from_numpy(a.astype(np.float32)).to(dev)
                        for a in (V, B, D)))


# ----------------------------------------------------------------- export
def as_general(params: Params) -> NDPPParams:
    """Either parameterisation as the general (V, B, D) triple."""
    if isinstance(params, ONDPPParams):
        return params.to_general()
    return params


def export_spectral(params: Params):
    """Learned kernel -> spectral (Youla) form ``Z X Z^T`` (Algorithm 4),
    on the params' device."""
    from ..core.youla import spectral_from_params

    g = as_general(params)
    return spectral_from_params(g.V, g.B, g.D, device=g.V.device)


def export_sampler(params: Params, block: int = 64):
    """Learned kernel -> preprocessed rejection sampler (Alg. 2), on the
    params' device (the tree's leaf level is ``block_outer_sums``)."""
    from ..core.rejection import preprocess

    g = as_general(params)
    return preprocess(g.V, g.B, g.D, block=block, device=g.V.device)


def export_catalog(params: Params, *, block: int = 64, **kwargs):
    """Learned kernel -> dynamic ``serve.catalog.Catalog`` (on the params'
    device unless ``device=`` or ``mesh=`` says otherwise)."""
    from ..serve.catalog import Catalog

    g = as_general(params)
    if kwargs.get("mesh") is None:
        kwargs.setdefault("device", g.V.device)
    return Catalog(g.V, g.B, g.D, block=block, **kwargs)


def ondpp_trial_bound(k: int) -> float:
    """Rank-only ceiling on ONDPP E[#trials]: each Youla pair contributes
    ``1 + 2 sigma/(sigma^2+1) <= 2``, so the Theorem 2 product is at most
    ``2^(K/2)``, whatever M and the data."""
    return 2.0 ** (k / 2)
