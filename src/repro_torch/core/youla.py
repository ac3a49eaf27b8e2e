"""Youla decomposition of the low-rank skew-symmetric kernel part
(port of ``repro/core/youla.py``; Algorithm 4 of the paper).

The nonzero eigenvalues of ``S = B (D - D^T) B^T`` (M x M, rank K) equal
those of the K x K matrix ``(D - D^T) B^T B``, so the decomposition costs
O(M K^2 + K^3).  As in the reference it runs once per kernel on the host
in float64 numpy; only the resulting spectral form moves to the device.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .types import SpectralNDPP


def _np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype=np.float64)


def youla_decompose_np(B, D) -> Tuple[np.ndarray, np.ndarray]:
    """Host float64 Youla decomposition: sigma (K/2,) nonnegative,
    descending, and Y (M, K) with
    ``S = sum_j sigma_j (y_{2j} y_{2j+1}^T - y_{2j+1} y_{2j}^T)``.

    Same arithmetic as the reference, except that ``B @ v_j`` for all
    eigenvectors is taken as two real matrix products up front instead of
    one complex product per pair (which would copy B to complex each time).
    """
    B = _np64(B)
    D = _np64(D)
    K = B.shape[1]
    C = (D - D.T) @ (B.T @ B)  # (K, K); eigenvalues purely imaginary pairs
    eigvals, eigvecs = np.linalg.eig(C)
    # keep one of each conjugate pair: eigenvalues i*sigma with sigma > 0
    order = np.argsort(-np.imag(eigvals), kind="stable")
    eigvals, eigvecs = eigvals[order], eigvecs[:, order]
    half = K // 2
    sig = np.imag(eigvals[:half]).copy()
    vecs = eigvecs[:, :half]  # (K, K/2) complex
    b_re = B @ np.real(vecs)   # (M, K/2): B v_j = b_re + i b_im
    b_im = B @ np.imag(vecs)
    y = np.zeros((B.shape[0], K), dtype=np.float64)
    for j in range(half):
        if sig[j] <= 1e-12:  # numerically rank-deficient pair
            sig[j] = 0.0
            # pick an arbitrary unit filler in the column space of B
            bv = b_re[:, j]
            if np.linalg.norm(bv) < 1e-12:
                bv = B[:, j % B.shape[1]]
            y[:, 2 * j] = bv / max(np.linalg.norm(bv), 1e-30)
            y[:, 2 * j + 1] = 0.0
            continue
        # unit complex eigenvector a + i b of S (Prop. 2)
        nrm = np.sqrt(np.sum(b_re[:, j] ** 2) + np.sum(b_im[:, j] ** 2))
        a, b = b_re[:, j] / nrm, b_im[:, j] / nrm
        y1 = a - b
        y2 = a + b
        # a ⟂ b and |a| = |b| = 1/sqrt(2) for a normal (skew) matrix, so
        # y1, y2 are unit in exact arithmetic; normalize to be safe
        y[:, 2 * j] = y1 / np.linalg.norm(y1)
        y[:, 2 * j + 1] = y2 / np.linalg.norm(y2)
    return sig, y


def youla_decompose(B: torch.Tensor, D: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``youla_decompose_np`` as tensors in B's dtype on B's device (sigma
    (K/2,), Y (M, K)), as the reference's ``youla_decompose``."""
    sig, y = youla_decompose_np(B, D)
    return (torch.as_tensor(sig, dtype=B.dtype).to(B.device),
            torch.as_tensor(y, dtype=B.dtype).to(B.device))


def spectral_from_params(V, B, D, *, device: DeviceLike = None
                         ) -> SpectralNDPP:
    """Spectral form Z = [V, Y], sigma (Section 4.1) as float32 tensors on
    ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    sig, y = youla_decompose_np(B, D)
    v = torch.as_tensor(V, dtype=torch.float32).to(dev)
    z = torch.cat([v, torch.as_tensor(y, dtype=torch.float32).to(dev)], 1)
    return SpectralNDPP(Z=z, sigma=torch.as_tensor(sig,
                                                   dtype=torch.float32).to(dev))


def youla_transform_np(B, D) -> Tuple[np.ndarray, np.ndarray]:
    """(sigma, T): the Youla change of basis as a K x K right transform,
    ``Y = B @ T``, in host float64 (the reference's arithmetic).

    Youla gives ``B (D - D^T) B^T = (B T) S_skew (B T)^T``; with B of full
    column rank that forces ``T S_skew T^T = D - D^T``, which holds for any
    later B.  A dynamic catalog therefore freezes (sigma, T) once and embeds
    a new or updated item as ``z_j = [v_j, b_j @ T]``: ``Z X Z^T`` stays an
    exact factorization of the live kernel under row inserts, updates and
    deletes as long as D is unchanged.
    """
    B = _np64(B)
    D = _np64(D)
    K = B.shape[1]
    C = (D - D.T) @ (B.T @ B)
    eigvals, eigvecs = np.linalg.eig(C)
    order = np.argsort(-np.imag(eigvals), kind="stable")
    eigvals, eigvecs = eigvals[order], eigvecs[:, order]
    half = K // 2
    sig = np.imag(eigvals[:half]).copy()
    t = np.zeros((K, K))
    for j in range(half):
        if sig[j] <= 1e-12:  # numerically rank-deficient pair
            sig[j] = 0.0
            u = np.real(eigvecs[:, j])
            if np.linalg.norm(B @ u) < 1e-12:
                u = np.zeros(K)
                u[j % K] = 1.0
            t[:, 2 * j] = u / max(np.linalg.norm(B @ u), 1e-30)
            continue
        v = eigvecs[:, j]
        u1 = np.real(v) - np.imag(v)
        u2 = np.real(v) + np.imag(v)
        t[:, 2 * j] = u1 / max(np.linalg.norm(B @ u1), 1e-30)
        t[:, 2 * j + 1] = u2 / max(np.linalg.norm(B @ u2), 1e-30)
    return sig, t


def spectral_from_transform(V, B, T, sigma, *, device: DeviceLike = None
                            ) -> SpectralNDPP:
    """Spectral form through a frozen Youla transform: Z = [V, B T], in
    float32 on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    v = torch.as_tensor(V, dtype=torch.float32).to(dev)
    b = torch.as_tensor(B, dtype=torch.float32).to(dev)
    t = torch.as_tensor(T, dtype=torch.float32).to(dev)
    sig = torch.as_tensor(sigma, dtype=torch.float32).to(dev)
    return SpectralNDPP(Z=torch.cat([v, b @ t], 1), sigma=sig)
