"""ONDPP learning with orthogonality constraints (Section 5, Eq. 14); port
of ``repro/core/learning.py``.

Loss = - (1/n) sum_i log( det(L_{Y_i}) / det(L + I) )
       + alpha * sum_i ||v_i||^2 / mu_i + beta * sum_i ||b_i||^2 / mu_i
       + gamma * sum_j log(1 + 2 sigma_j / (sigma_j^2 + 1))

The gamma term is the log of the expected number of rejections (Theorem
2), so it trades predictive fit against sampling speed.

Constraints (footnote ¶): after each optimizer step
    B <- qr(B).Q            (B^T B = I, R's diagonal made positive)
    V <- V - B (B^T V)      (V^T B = 0; B is orthonormal at that point)
    sigma <- |sigma|

Also the unconstrained NDPP baseline (Gartrell et al. 2021) and the
symmetric low-rank DPP baseline (Gartrell et al. 2017) of Table 2.
Gradients come from ``torch.autograd``: no kernel is on this path (the
basket Grams are (n, k_max, k_max), the normalizer a 2K x 2K
determinant).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import random as trandom
from ..device import DeviceLike, resolve_device
from .types import NDPPParams, ONDPPParams, d_from_sigma

_DET_EPS = 1e-5  # Appendix C: epsilon*I added to each L_{Y_i}


class Baskets(NamedTuple):
    """Padded baskets: items (n, k_max) int64, mask (n, k_max) float32."""

    items: torch.Tensor
    mask: torch.Tensor


def _padded_logdets(ly: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """log det(L_Y + eps I) of padded (n, k, k) basket kernels: padding rows
    get diagonal exactly 1 (a factor 1 in the det) and the eps jitter goes
    on real rows only, so a basket's log-likelihood does not move with
    its padding; a determinant that is not positive reads -1e9."""
    eye = torch.eye(ly.shape[-1], dtype=ly.dtype, device=ly.device)
    ly = ly + (1.0 - mask)[..., None] * eye + _DET_EPS * mask[..., None] * eye
    sign, logdet = torch.linalg.slogdet(ly)
    return torch.where(sign > 0, logdet, torch.full_like(logdet, -1e9))


def _basket_logdets(V: torch.Tensor, B: torch.Tensor, D: torch.Tensor,
                    baskets: Baskets) -> torch.Tensor:
    """log det(L_{Y_i} + eps I) for each padded basket (unit padding diag)."""
    m = baskets.mask[..., None]
    vy = V[baskets.items] * m                    # (n, k, K)
    by = B[baskets.items] * m
    ly = vy @ vy.transpose(-1, -2) + (by @ (D - D.T)) @ by.transpose(-1, -2)
    return _padded_logdets(ly, baskets.mask)


def log_normalizer(V: torch.Tensor, B: torch.Tensor, D: torch.Tensor
                   ) -> torch.Tensor:
    """log det(L + I) = log det(I_{2K} + X Z^T Z), O(M K^2)."""
    z = torch.cat([V, B], dim=1)
    k = V.shape[1]
    g = z.T @ z
    x = torch.zeros((2 * k, 2 * k), dtype=z.dtype, device=z.device)
    x[:k, :k] = torch.eye(k, dtype=z.dtype, device=z.device)
    x[k:, k:] = D - D.T
    eye = torch.eye(2 * k, dtype=z.dtype, device=z.device)
    return torch.linalg.slogdet(eye + x @ g)[1]


def _inv_freq_reg(w: torch.Tensor, item_freq: torch.Tensor) -> torch.Tensor:
    inv_freq = 1.0 / item_freq.clamp_min(1.0)
    return torch.sum(torch.sum(w ** 2, dim=1) * inv_freq)


def ondpp_loss(params: ONDPPParams, baskets: Baskets,
               item_freq: torch.Tensor, alpha: float = 0.01,
               beta: float = 0.01, gamma: float = 0.1) -> torch.Tensor:
    """Eq. 14 (mean NLL + regularizers)."""
    d = d_from_sigma(params.sigma)
    ll = _basket_logdets(params.V, params.B, d, baskets)
    nll = -(torch.mean(ll) - log_normalizer(params.V, params.B, d))
    s = params.sigma
    reg_s = gamma * torch.sum(torch.log1p(2.0 * s / (s ** 2 + 1.0)))
    return (nll + alpha * _inv_freq_reg(params.V, item_freq)
            + beta * _inv_freq_reg(params.B, item_freq) + reg_s)


def ndpp_loss(params: NDPPParams, baskets: Baskets, item_freq: torch.Tensor,
              alpha: float = 0.01, beta: float = 0.01) -> torch.Tensor:
    """Unconstrained NDPP baseline objective (Gartrell et al. 2021)."""
    ll = _basket_logdets(params.V, params.B, params.D, baskets)
    nll = -(torch.mean(ll) - log_normalizer(params.V, params.B, params.D))
    return (nll + alpha * _inv_freq_reg(params.V, item_freq)
            + beta * _inv_freq_reg(params.B, item_freq))


def symmetric_dpp_loss(V: torch.Tensor, baskets: Baskets,
                       item_freq: torch.Tensor, alpha: float = 0.01
                       ) -> torch.Tensor:
    """Symmetric low-rank DPP baseline (Gartrell et al. 2017): L = V V^T."""
    vy = V[baskets.items] * baskets.mask[..., None]
    ll = _padded_logdets(vy @ vy.transpose(-1, -2), baskets.mask)
    eye = torch.eye(V.shape[1], dtype=V.dtype, device=V.device)
    logz = torch.linalg.slogdet(eye + V.T @ V)[1]
    return -(torch.mean(ll) - logz) + alpha * _inv_freq_reg(V, item_freq)


def project_constraints(params: ONDPPParams) -> ONDPPParams:
    """Enforce B^T B = I, V^T B = 0, sigma >= 0 (footnote ¶ of Section 5)."""
    q, r = torch.linalg.qr(params.B)
    # keep the orientation deterministic: positive diagonal of R
    signs = torch.sign(torch.diagonal(r))
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    b = q * signs[None, :]
    v = params.V - b @ (b.T @ params.V)
    # |sigma| rather than relu: clipping at 0 kills the gradient and the
    # skew part collapses for good
    return ONDPPParams(V=v, B=b, sigma=torch.abs(params.sigma))


def _init_keys(key, device: DeviceLike) -> torch.Tensor:
    """The init's three keys on the device it draws on: ``device``, else a
    CUDA key's own device, else ``cuda`` (``resolve_device``)."""
    if device is None and isinstance(key, torch.Tensor) and key.is_cuda:
        dev = key.device
    else:
        dev = resolve_device(device)
    return trandom.split(trandom.as_key(key, dev), 3)


def init_ondpp(key, m: int, k: int, *, device: DeviceLike = None
               ) -> ONDPPParams:
    """Paper init: V, B ~ uniform(0, 1); sigma from |N(0,1)|; then project.
    Draws on ``device`` (default: a CUDA key's device, else ``cuda``) from
    the key schedule of the reference: V and B bit for bit, sigma to
    float32 rounding (``random.normal``)."""
    kv, kb, ks = _init_keys(key, device)
    v = trandom.uniform(kv, (m, k))
    b = trandom.uniform(kb, (m, k))
    sigma = torch.abs(trandom.normal(ks, (k // 2,)))
    return project_constraints(ONDPPParams(V=v, B=b, sigma=sigma))


def init_ndpp(key, m: int, k: int, *, device: DeviceLike = None
              ) -> NDPPParams:
    """V, B ~ uniform(0, 1), D ~ N(0, 1), as the reference draws them, on
    ``device`` as ``init_ondpp`` chooses it."""
    kv, kb, kd = _init_keys(key, device)
    return NDPPParams(V=trandom.uniform(kv, (m, k)),
                      B=trandom.uniform(kb, (m, k)),
                      D=trandom.normal(kd, (k, k)))


def item_frequencies(baskets: Baskets, m: int) -> torch.Tensor:
    """mu_i: the number of baskets containing item i, float32 (m,)."""
    flat = torch.where(baskets.mask.bool(), baskets.items,
                       torch.full_like(baskets.items, m))
    return torch.bincount(flat.reshape(-1), minlength=m + 1)[:m].float()
