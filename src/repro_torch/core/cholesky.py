"""Linear-time Cholesky-based NDPP sampling (Section 3, Algorithm 1 RHS);
port of ``repro/core/cholesky.py``.

With the low-rank form ``K = Z W Z^T`` (Eq. 1) only the 2K x 2K inner
matrix needs updating per item (Eqs. 4-5): O(M K^2) time and O(M K)
memory.  The scan over the M items runs in the ``cholesky_scan`` kernel
(one draw a CTA, its state on chip; the plain version on the CPU).

Every sampler takes one key (2,) and returns an inclusion mask (M,), or a
stack of keys (N, 2) and returns (N, M), as ``jax.vmap`` over the keys
would: draw n's uniforms are ``uniform(key_n, (M,))``
(``uniform(key_n, (M + pad,))`` in the blocked variant), so the draws
equal the reference's key for key.
"""
from __future__ import annotations

from typing import Tuple

import torch

from .. import random as trandom
from ..kernels.cholesky_scan import ops as scan_ops
from .types import NDPPParams, SpectralNDPP, x_from_sigma


def marginal_inner(Z: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """W = X (I_{2K} + Z^T Z X)^{-1}  so that  K = Z W Z^T  (Eq. 1)."""
    g = Z.T @ Z
    eye = torch.eye(X.shape[0], dtype=Z.dtype, device=Z.device)
    return X @ torch.linalg.inv(eye + g @ X)


def marginal_inner_from_params(
    params: NDPPParams,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(Z, X, W) from the low-rank parameterization: Z = [V, B],
    X = diag(I_K, D - D^T)."""
    z = torch.cat([params.V, params.B], dim=1)
    k = params.K
    x = torch.zeros((2 * k, 2 * k), dtype=z.dtype, device=z.device)
    x[:k, :k] = torch.eye(k, dtype=z.dtype, device=z.device)
    x[k:, k:] = params.D - params.D.T
    return z, x, marginal_inner(z, x)


def _scan(Z: torch.Tensor, W: torch.Tensor, key, n_uniform: int
          ) -> torch.Tensor:
    """Masks of the scan over the rows of Z from W, with each draw's
    uniforms ``uniform(key_n, (n_uniform,))`` (their first M used)."""
    keys = trandom.as_key(key, Z.device)
    u = trandom.uniform(keys.reshape(-1, 2), (n_uniform,))[:, :Z.shape[0]]
    take, _ = scan_ops.cholesky_scan(Z.contiguous(), W.contiguous(),
                                     u.contiguous())
    return take.reshape(keys.shape[:-1] + (Z.shape[0],))


def sample_cholesky(Z: torch.Tensor, X: torch.Tensor, key) -> torch.Tensor:
    """Exact NDPP draws: boolean inclusion masks, (M,) for one key, (N, M)
    for N keys.  Sequential over M by construction (each inclusion decision
    conditions all later ones); each step is O(K^2) work on a 2K x 2K
    state."""
    return sample_cholesky_inner(Z, marginal_inner(Z, X), key)


def sample_cholesky_inner(Z: torch.Tensor, W: torch.Tensor, key
                          ) -> torch.Tensor:
    """The sequential inclusion scan from a precomputed inner matrix W."""
    return _scan(Z, W, key, Z.shape[0])


def sample_cholesky_params(params: NDPPParams, key) -> torch.Tensor:
    z, _, w = marginal_inner_from_params(params)
    return sample_cholesky_inner(z, w, key)


def sample_cholesky_spectral(sp: SpectralNDPP, key) -> torch.Tensor:
    return sample_cholesky(sp.Z, x_from_sigma(sp.K, sp.sigma), key)


def sample_cholesky_blocked(Z: torch.Tensor, X: torch.Tensor, key,
                            block: int = 256) -> torch.Tensor:
    """The reference's block-streamed variant: the same scan, with each
    draw's uniforms ``uniform(key_n, (M + pad,))`` for Z padded with zero
    rows to a multiple of ``block``.  The pad rows come after every real
    row and change none of their decisions (p = 0 is never taken, and
    their downdate is zero), so the scan runs over the M real rows and the
    pad's uniforms go unused.  The kernel streams rows in tiles of its own,
    so here the variant differs from ``sample_cholesky`` only in its
    uniforms."""
    m = Z.shape[0]
    return _scan(Z, marginal_inner(Z, X), key, m + (-m) % block)
