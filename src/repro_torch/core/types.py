"""Parameter containers for NDPP kernels (port of ``repro/core/types.py``).

The low-rank NDPP kernel over M items is

    L = V V^T + B (D - D^T) B^T,   V, B in R^{M x K}, D in R^{K x K},

and its spectral (Youla) form is ``L = Z X Z^T`` with ``Z = [V, Y]``
(M x 2K).  The symmetric proposal kernel of Section 4.1 is
``Lhat = Z Xhat Z^T``.  Tensors are float32 and live on one device.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class NDPPParams:
    """General low-rank NDPP kernel: ``L = V V^T + B (D - D^T) B^T``.

    V: (M, K) symmetric-part factor, B: (M, K) skew-part factor, D: (K, K)
    (only its skew part ``D - D^T`` enters L).
    """

    V: torch.Tensor
    B: torch.Tensor
    D: torch.Tensor

    @property
    def M(self) -> int:
        return self.V.shape[0]

    @property
    def K(self) -> int:
        return self.V.shape[1]


@dataclasses.dataclass(frozen=True)
class ONDPPParams:
    """Orthogonality-constrained NDPP (Section 5; the reference's
    ``ONDPPParams``, ``repro/core/types.py:66``).

    ``D - D^T`` is block-diagonal with ``[[0, s], [-s, 0]]`` blocks built
    from ``sigma`` (K/2,), nonnegative.  The learner keeps ``B^T B = I`` and
    ``V^T B = 0`` by projection (``core/learning.py::project_constraints``).
    """

    V: torch.Tensor      # (M, K)
    B: torch.Tensor      # (M, K)
    sigma: torch.Tensor  # (K // 2,)

    @property
    def M(self) -> int:
        return self.V.shape[0]

    @property
    def K(self) -> int:
        return self.V.shape[1]

    def to_general(self) -> NDPPParams:
        return NDPPParams(self.V, self.B, d_from_sigma(self.sigma))


@dataclasses.dataclass(frozen=True)
class SpectralNDPP:
    """Spectral form ``L = Z X Z^T`` with Z = [V, y_1..y_K] (M x 2K) and
    sigma (K/2,) the nonnegative Youla eigenvalues of the skew part."""

    Z: torch.Tensor
    sigma: torch.Tensor

    @property
    def M(self) -> int:
        return self.Z.shape[0]

    @property
    def K(self) -> int:
        return self.Z.shape[1] // 2

    def x_diag_hat(self) -> torch.Tensor:
        """Diagonal of Xhat: (2K,) = [1]*K ++ [s_1, s_1, ..., s_{K/2}]."""
        ones = torch.ones(self.K, dtype=self.sigma.dtype,
                          device=self.sigma.device)
        return torch.cat([ones, torch.repeat_interleave(self.sigma, 2)])

    def x_matrix(self) -> torch.Tensor:
        """Dense 2K x 2K block-diagonal X (Eq. 7)."""
        return x_from_sigma(self.K, self.sigma)


def d_from_sigma(sigma: torch.Tensor) -> torch.Tensor:
    """Eq. 13: D = blockdiag([[0, s_j], [0, 0]]) for j = 1..K/2."""
    half = sigma.shape[0]
    d = torch.zeros((2 * half, 2 * half), dtype=sigma.dtype,
                    device=sigma.device)
    idx = torch.arange(half, device=sigma.device)
    d[2 * idx, 2 * idx + 1] = sigma
    return d


def x_from_sigma(k: int, sigma: torch.Tensor) -> torch.Tensor:
    """Dense X = diag(I_K, [[0, s], [-s, 0]] blocks) in R^{2K x 2K}."""
    x = torch.zeros((2 * k, 2 * k), dtype=sigma.dtype, device=sigma.device)
    ar = torch.arange(k, device=sigma.device)
    x[ar, ar] = 1.0
    i = k + 2 * torch.arange(sigma.shape[0], device=sigma.device)
    x[i, i + 1] = sigma
    x[i + 1, i] = -sigma
    return x


def dense_l(params: NDPPParams) -> torch.Tensor:
    """Materialize the full M x M kernel (tests / tiny M only)."""
    skew = params.D - params.D.T
    return params.V @ params.V.T + params.B @ skew @ params.B.T


def dense_l_spectral(sp: SpectralNDPP) -> torch.Tensor:
    return sp.Z @ sp.x_matrix() @ sp.Z.T


def dense_l_hat(sp: SpectralNDPP) -> torch.Tensor:
    return (sp.Z * sp.x_diag_hat()[None, :]) @ sp.Z.T
