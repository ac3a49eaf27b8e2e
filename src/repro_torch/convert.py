"""Carry a kernel's state across from numpy arrays.

``sampler_from_numpy`` builds the port's ``NDPPSampler`` from the arrays of
an already preprocessed sampler (for example the reference's, read out as
numpy), so that both sample from bit-identical state and their draws can be
compared key for key.  ``catalog_state_from_numpy`` does the same for a
dynamic catalog's ``CatalogState`` and ``mcmc_states_from_numpy`` for a pool
of MCMC chains; ``params_from_numpy`` carries the factors of
``L = V V^T + B (D - D^T) B^T``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .core.dynamic import DualProposal
from .core.mcmc import MCMCState
from .core.rejection import NDPPSampler
from .core.tree import SampleTree
from .core.types import NDPPParams, SpectralNDPP
from .device import DeviceLike, resolve_device
from .serve.catalog import CatalogState


def _f32(a, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(dev)


def tree_from_numpy(lam, W, levels: Sequence, block: int, M: int,
                    device: DeviceLike = None) -> SampleTree:
    """SampleTree from lam (R,), padded rows W (M_pad, R) and per-level
    node arrays root first, each (2^l, R, R), stacked into the port's one
    contiguous node array."""
    dev = resolve_device(device)
    nodes = np.concatenate([np.asarray(lv, np.float32).reshape(
        -1, *np.shape(lv)[-2:]) for lv in levels])
    tree = SampleTree(W=_f32(W, dev), lam=_f32(lam, dev),
                      nodes=_f32(nodes, dev), block=int(block), M=int(M))
    if tree.n_blocks * block != tree.W.shape[0] or \
            nodes.shape[0] != 2 * tree.n_blocks - 1:
        raise ValueError(f"W rows {tree.W.shape[0]} and {nodes.shape[0]} "
                         f"nodes do not form a tree of blocks of {block}")
    return tree


def sampler_from_numpy(Z, sigma, lam, W, levels: Sequence, block: int, M: int,
                       device: DeviceLike = None) -> NDPPSampler:
    """NDPPSampler from a spectral form (Z (M, 2K), sigma (K/2,)) and a
    proposal tree (see ``tree_from_numpy``)."""
    dev = resolve_device(device)
    return NDPPSampler(sp=SpectralNDPP(Z=_f32(Z, dev), sigma=_f32(sigma, dev)),
                       tree=tree_from_numpy(lam, W, levels, block, M, dev))


def catalog_state_from_numpy(version: int, proposal_version: int, m: int,
                             Z, sigma, proposal_Z, proposal_sigma, lam, u, W,
                             levels: Sequence, block: int,
                             device: DeviceLike = None) -> CatalogState:
    """CatalogState from a catalog version's arrays: the live spectral
    state (Z at capacity rows, sigma) and the proposal snapshot (its
    spectral state, dual eigens (lam, u) and dual tree over W)."""
    dev = resolve_device(device)
    tree = tree_from_numpy(lam, W, levels, block, np.shape(W)[0], dev)
    prop = DualProposal(tree=tree, u=_f32(u, dev), sp=SpectralNDPP(
        Z=_f32(proposal_Z, dev), sigma=_f32(proposal_sigma, dev)))
    return CatalogState(version=int(version),
                        proposal_version=int(proposal_version),
                        sp=SpectralNDPP(Z=_f32(Z, dev),
                                        sigma=_f32(sigma, dev)),
                        proposal=prop, m=int(m))


def mcmc_states_from_numpy(items, mask, minv, step,
                           device: DeviceLike = None) -> MCMCState:
    """A pool of C chains: items (C, R), mask (C, R), minv (C, R, R),
    step (C,)."""
    dev = resolve_device(device)
    return MCMCState(
        items=torch.from_numpy(np.array(items, np.int64)).to(dev),
        mask=torch.from_numpy(np.array(mask, bool)).to(dev),
        minv=_f32(minv, dev),
        step=torch.from_numpy(np.array(step, np.int64).reshape(-1)).to(dev))


def params_from_numpy(V, B, D, device: DeviceLike = None) -> NDPPParams:
    """NDPPParams with float32 tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return NDPPParams(V=_f32(V, dev), B=_f32(B, dev), D=_f32(D, dev))
