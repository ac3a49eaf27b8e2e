"""Greedy conditioning / MAP inference for NDPPs (Gartrell et al. 2021
§4.2); port of ``repro/core/map_inference.py``.

Used for the paper's MPR (next-item prediction) metric and for basket
completion.  The marginal gain of adding item i to an observed set J is the
Schur complement

    det(L_{J u i}) / det(L_J) = z_i^T W_J z_i,
    W_J = X - X Z_J^T (Z_J X Z_J^T)^{-1} Z_J X,

a quadratic form over all M items at once: the ``bilinear`` kernel
(``core/bilinear.py::conditional_scores``; on the card
``csrc/quad_form.cuh``).  W_J is not symmetric, and the kernel reads
W + W^T, which a quadratic form allows.

The reference's ``lax.scan`` and ``vmap`` loops are Python loops here
that keep every value on the device: the greedy argmax and the observed
set stay tensors, and the held-out ranks are reduced on the device.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from .. import random as trandom
from .bilinear import conditional_inner_matrix, conditional_scores
from .cholesky import marginal_inner, sample_cholesky_inner
from .types import NDPPParams


def _zx(params: NDPPParams) -> Tuple[torch.Tensor, torch.Tensor]:
    """Z = [V, B] (M, 2K) and X = diag(I_K, D - D^T)."""
    z = torch.cat([params.V, params.B], dim=1)
    k = params.K
    x = torch.zeros((2 * k, 2 * k), dtype=z.dtype, device=z.device)
    x[:k, :k] = torch.eye(k, dtype=z.dtype, device=z.device)
    x[k:, k:] = params.D - params.D.T
    return z, x


def _taken_mask(observed: torch.Tensor, obs_mask: torch.Tensor,
                m: int) -> torch.Tensor:
    """(M,) bool marking the observed items of a padded set.  Padding slots
    point past the end and are dropped, so they cannot mark item M-1."""
    idx = torch.where(obs_mask.bool(), observed.long(),
                      torch.full_like(observed, m, dtype=torch.long))
    taken = torch.zeros(m + 1, dtype=torch.bool, device=observed.device)
    taken[idx] = True
    return taken[:m]


def _scores(z: torch.Tensor, x: torch.Tensor, observed: torch.Tensor,
            obs_mask: torch.Tensor) -> torch.Tensor:
    """``next_item_scores`` on Z and X: the conditional gains of every row
    of z given the padded set, its own items at -inf."""
    scores = conditional_scores(z, z[observed.long().clamp_min(0)],
                                obs_mask.to(z.dtype), x)
    # observed items must not be suggested again
    taken = _taken_mask(observed, obs_mask, z.shape[0])
    return scores.masked_fill(taken, -float("inf"))


def next_item_scores(params: NDPPParams, observed: torch.Tensor,
                     obs_mask: torch.Tensor) -> torch.Tensor:
    """det(L_{J u i})/det(L_J) for every item i given the padded set J
    (observed (k_pad,) ids, obs_mask (k_pad,)); observed items read -inf."""
    z, x = _zx(params)
    return _scores(z, x, observed, obs_mask)


def greedy_map(params: NDPPParams, k: int) -> torch.Tensor:
    """Greedy (sub)determinant maximisation: add the item with the largest
    conditional gain, k times.  Returns the (k,) item ids (int64, on the
    params' device)."""
    z, x = _zx(params)
    observed = torch.full((k,), -1, dtype=torch.long, device=z.device)
    mask = torch.zeros(k, dtype=torch.bool, device=z.device)
    for t in range(k):
        observed[t] = torch.argmax(_scores(z, x, observed, mask))
        mask[t] = True
    return observed


def _held_out_percentiles(score_fn: Callable, baskets: torch.Tensor,
                          mask: torch.Tensor, key
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The hold-one-out protocol (Appendix B.1): drop one random item from
    each basket, score every item given the rest with
    ``score_fn(basket, rest_mask) -> (M,)`` (-inf marks observed or invalid
    items), and return (percentiles, usable): the held item's percentile
    among the valid items, and which baskets had an item to hold out.

    Basket n holds out ``randint(split(key, n_b)[n], (), 0, max(|Y_n|, 1))``,
    the reference's draw, so a model and a baseline evaluated with the same
    key hold out the same items."""
    n_b = baskets.shape[0]
    dev = baskets.device
    keys = trandom.split(trandom.as_key(key, dev), n_b)
    present = mask.bool()
    n_items = present.sum(dim=1)
    pick = trandom.randint(keys, (), 0, n_items.clamp_min(1))
    rows = torch.arange(n_b, device=dev)
    held = baskets[rows, pick].long()
    rest = present.clone()
    rest[rows, pick] = False
    prs = torch.empty(n_b, dtype=torch.float32, device=dev)
    for n in range(n_b):
        scores = score_fn(baskets[n], rest[n])
        valid = torch.isfinite(scores)
        rank = ((scores <= scores[held[n]]) & valid).sum()
        prs[n] = 100.0 * rank.float() / valid.sum().clamp_min(1).float()
    return prs, n_items > 0


def _masked_mean(prs: torch.Tensor, usable: torch.Tensor) -> torch.Tensor:
    w = usable.to(prs.dtype)
    return torch.sum(prs * w) / torch.sum(w).clamp_min(1.0)


def mean_percentile_rank(params: NDPPParams, baskets: torch.Tensor,
                         mask: torch.Tensor, key) -> torch.Tensor:
    """MPR (Appendix B.1): hold one random item out of each test basket and
    rank it among the items not in the rest by conditional score.  Empty
    baskets (nothing to hold out) do not enter the mean."""
    z, x = _zx(params)
    prs, usable = _held_out_percentiles(
        lambda b, m: _scores(z, x, b, m), baskets, mask, key)
    return _masked_mean(prs, usable)


def mpr_frequency_baseline(item_freq: torch.Tensor, baskets: torch.Tensor,
                           mask: torch.Tensor, key) -> torch.Tensor:
    """The item-popularity MPR baseline under the same hold-one-out
    protocol: the held item is ranked by training frequency, ties broken
    by item id so that the ranking is a strict order, observed items
    excluded."""
    m_total = item_freq.shape[0]
    # the strict (freq, id) ranking on the host in exact integers: freq * M
    # + id in floating point stops being a strict order once counts * M
    # pass the mantissa
    freq_h = item_freq.detach().cpu().numpy().astype(np.float64)
    order = np.lexsort((np.arange(m_total), freq_h))  # freq major, id minor
    rank = np.empty(m_total, np.int64)
    rank[order] = np.arange(m_total)
    base = torch.from_numpy(rank).to(device=baskets.device,
                                     dtype=torch.float32)

    def score(basket, rest_mask):
        return base.masked_fill(_taken_mask(basket, rest_mask, m_total),
                                -float("inf"))

    prs, usable = _held_out_percentiles(score, baskets, mask, key)
    return _masked_mean(prs, usable)


def conditional_sample(params: NDPPParams, observed: torch.Tensor,
                       obs_mask: torch.Tensor, key) -> torch.Tensor:
    """Exact draws from the NDPP conditioned on ``observed ⊆ Y``: bool
    inclusion masks over the completion items, (M,) for one key (2,),
    (N, M) for a key stack (N, 2); observed items are always False.

    The conditional of ``P(Y) ∝ det(L_Y)`` on containing J is an NDPP over
    the complement with kernel ``Z W_J Z^T`` (the W_J that scores next
    items), so the completion is a Cholesky draw (the ``cholesky_scan``
    kernel, one draw a CTA) on rows with the observed items zeroed: a zero
    row has marginal 0 and is never taken."""
    z_c, w_marg = conditional_rows(*_zx(params), observed, obs_mask)
    return sample_cholesky_inner(z_c, w_marg, key)


def conditional_rows(z: torch.Tensor, x: torch.Tensor,
                     observed: torch.Tensor, obs_mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rows and inner matrix a conditional draw scans: Z with the
    observed rows zeroed, and W = marginal_inner(Z_c, W_J)."""
    z_obs = z[observed.long().clamp_min(0)]
    w_j = conditional_inner_matrix(z_obs, obs_mask.to(z.dtype), x)
    taken = _taken_mask(observed, obs_mask, z.shape[0])
    z_c = z.masked_fill(taken[:, None], 0.0)
    return z_c, marginal_inner(z_c, w_j).contiguous()
