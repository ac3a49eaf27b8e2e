"""Fixed-size (k-NDPP) sampling; port of ``repro/core/kdpp.py`` (the
paper's Section 7 future-work extension).

A k-DPP conditions a DPP on |Y| = k: its eigenvector selection is the
exact size-k walk of Kulesza & Taskar (2012, Alg. 8) over the elementary
symmetric polynomial (ESP) table instead of independent coins.  For the
nonsymmetric case the proposal is the k-DPP of the symmetric L̂, accepted
with det(L_Y)/det(L̂_Y): Theorem 1 dominates subset-wise, so the scheme
stays exact on the size-k slice.

The samplers take one key (2,) or, where said, a stack (N, 2), as
``jax.vmap`` over the keys would; the draws equal the reference's key for
key.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import random as trandom
from .rejection import NDPPSampler, RejectionSample, _sample_lanes
from .tree import AnyTree, sample_elementary_batch


def elementary_symmetric(lam: torch.Tensor, k: int) -> torch.Tensor:
    """ESP table E[i, j] = e_j(λ_1..λ_i), (N+1, k+1), in lam's dtype.
    e_j grows like C(N, j): float32 overflows once N and j reach the
    hundreds (``elementary_symmetric_log`` does not)."""
    row = torch.zeros(k + 1, dtype=lam.dtype, device=lam.device)
    row[0] = 1.0
    rows = [row]
    zero = row[:1] * 0
    for i in range(lam.shape[0]):
        row = row + lam[i] * torch.cat([zero, row[:-1]])
        rows.append(row)
    return torch.stack(rows)


def elementary_symmetric_log(lam: torch.Tensor, k: int) -> torch.Tensor:
    """log ESP table: E[i, j] = log e_j(λ_1..λ_i), -inf where e_j = 0; the
    recurrence as a logaddexp, so it never overflows.  Requires λ >= 0."""
    neg_inf = torch.full((1,), -torch.inf, dtype=lam.dtype, device=lam.device)
    log_lam = torch.where(lam > 0, torch.log(lam.clamp_min(1e-30)), neg_inf)
    row = neg_inf.expand(k + 1).clone()
    row[0] = 0.0
    rows = [row]
    for i in range(lam.shape[0]):
        row = torch.logaddexp(row, log_lam[i] + torch.cat([neg_inf, row[:-1]]))
        rows.append(row)
    return torch.stack(rows)


def sample_fixed_size_e(lam: torch.Tensor, k: int, key) -> torch.Tensor:
    """Exact size-k eigenvector selection (Kulesza & Taskar Alg. 8) for a
    key (2,) or keys (N, 2): boolean masks (..., N_eig) with exactly k True
    (given e_k > 0), walking the log-space ESP table from the last
    eigenvalue down; a draw must take every remaining eigenvalue once as
    many are left as it still needs."""
    n = lam.shape[0]
    esp = elementary_symmetric_log(lam, k)                       # (n+1, k+1)
    keys = trandom.as_key(key, lam.device)
    us = trandom.uniform(keys, (n,))                             # (..., n)
    log_lam = torch.log(lam.clamp_min(1e-30))
    rem = torch.full(keys.shape[:-1], k, dtype=torch.int64, device=lam.device)
    takes = torch.empty(us.shape, dtype=torch.bool, device=lam.device)
    for i in range(n):
        idx = n - 1 - i
        denom = esp[idx + 1][rem]
        num = log_lam[idx] + esp[idx][(rem - 1).clamp_min(0)]
        p = torch.where((lam[idx] > 0) & torch.isfinite(denom),
                        torch.exp(num - denom), torch.zeros_like(denom))
        take = ((us[..., i] < p) & (rem > 0)) | (rem >= idx + 1)
        rem = rem - take.long()
        takes[..., i] = take
    return takes.flip(-1)


def sample_kdpp(tree: AnyTree, k: int, key
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Y ~ k-DPP(L̂) for a key (2,) or keys (N, 2): the size-k eigenvector
    selection, then the tree's elementary draw (every elementary draw has
    exactly |E| items).  Returns (items, mask), (..., R)."""
    keys = trandom.as_key(key, tree.device)
    ks = trandom.split(keys.reshape(-1, 2))                       # (N, 2, 2)
    e_masks = sample_fixed_size_e(tree.lam, k, ks[:, 0])
    items, mask = sample_elementary_batch(tree, e_masks, ks[:, 1])
    return (items.reshape(keys.shape[:-1] + (-1,)),
            mask.reshape(keys.shape[:-1] + (-1,)))


def sample_k_ndpp(sampler: NDPPSampler, k: int, key,
                  max_trials: int = 1000) -> RejectionSample:
    """Fixed-size rejection sampling for the NDPP (Algorithm 2 with the
    proposal restricted to the size-k slice), one key (2,): trial t draws
    ``kk, k_prop, k_acc = split(kk, 3)``, proposes ``sample_kdpp(k_prop)``
    and accepts with det(L_Y)/det(L̂_Y)."""
    key = trandom.as_key(key, sampler.device)
    res = _sample_lanes(sampler, key[None],
                        lambda ks: sample_kdpp(sampler.tree, k, ks),
                        max_trials)
    return RejectionSample(*(x[0] for x in res))
