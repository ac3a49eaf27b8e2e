"""Carry a kernel's state across from numpy arrays.

``sampler_from_numpy`` builds the port's ``NDPPSampler`` from the arrays of
an already preprocessed sampler (for example the reference's, read out as
numpy), so that both sample from bit-identical state and their draws can be
compared key for key.  ``catalog_state_from_numpy`` does the same for a
dynamic catalog's ``CatalogState`` and ``mcmc_states_from_numpy`` for a pool
of MCMC chains; ``params_from_numpy`` carries the factors of
``L = V V^T + B (D - D^T) B^T``, ``ondpp_params_from_numpy`` those of an
ONDPP and ``baskets_from_numpy`` a set of padded baskets.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

from .core.dynamic import DualProposal
from .core.learning import Baskets
from .core.mcmc import MCMCState
from .core.rejection import NDPPSampler
from .core.tree import SampleTree
from .core.types import NDPPParams, ONDPPParams, SpectralNDPP
from .device import DeviceLike, resolve_device
from .models.config import ModelConfig
from .models.model import LM, layer_descriptors
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


def ondpp_params_from_numpy(V, B, sigma, device: DeviceLike = None
                            ) -> ONDPPParams:
    """ONDPPParams with float32 tensors on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return ONDPPParams(V=_f32(V, dev), B=_f32(B, dev),
                       sigma=_f32(sigma, dev))


def baskets_from_numpy(items, mask, device: DeviceLike = None) -> Baskets:
    """Padded baskets: items (n, k_max) as int64 and mask (n, k_max) as
    float32 on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return Baskets(
        items=torch.from_numpy(np.array(items, np.int64)).to(dev),
        mask=_f32(mask, dev))


# ------------------------------------------------------------ LM template
# The reference's tree: {"embed": {"table", "unembed"?}, "prefix": [layer],
# "stack": {"pos{i}": layer with a leading repeat dim} (scan_layers) or
# [layer] (repeat-major), "final_norm": {"w"} or {}}; a layer is {"norm1",
# "mixer": {"wq", "wk", "wv", "wo", "q_norm"?, "k_norm"?} or, for a Mamba2
# layer, {"w_in", "conv_w", "a_log", "dt_bias", "d_skip", "norm_w",
# "w_out"}, "norm2"?, "ffn": {"wg", "wu", "wd"}?}.  The port names the
# same leaves "embed.table", "prefix.{i}.mixer.wq", "layers.{j}.ffn.wd",
# "final_norm.w" with j = repeat * len(pattern) + pos, and keeps the
# reference's einsum layouts (wq (d, h, hd), wo (h, hd, d), wg (d, f),
# table (V, d), unembed (d, V)), so every leaf carries across unchanged
# in shape.


def _flatten(tree: Dict[str, Any], prefix: str) -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _unflatten(named: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for name, v in named.items():
        if not name.startswith(prefix):
            continue
        node = out
        *path, leaf = name[len(prefix):].split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _layer_template(cfg: ModelConfig, desc: dict) -> Dict[str, Any]:
    """A layer's tree with every subtree present, parameterless norms as
    {} (the reference's ``init_norm`` for non-parametric LayerNorm)."""
    t: Dict[str, Any] = {"norm1": {}, "mixer": {}}
    if desc["ffn"]:
        t["norm2"], t["ffn"] = {}, {}
    return t


def _stack_index(cfg: ModelConfig):
    prefix, pattern = layer_descriptors(cfg)
    n_rep = (cfg.n_layers - len(prefix)) // len(pattern)
    return prefix, pattern, n_rep


def lm_named_from_tree(cfg: ModelConfig, tree) -> Dict[str, np.ndarray]:
    """The reference's parameter tree (numpy leaves) as the port's
    parameter names -> arrays, un-stacking ``stack/pos{i}``."""
    prefix, pattern, n_rep = _stack_index(cfg)
    out = dict(_flatten(tree["embed"], "embed."))
    for i, lp in enumerate(tree["prefix"]):
        out.update(_flatten(lp, f"prefix.{i}."))
    stack = tree["stack"]
    for r in range(n_rep):
        for pos in range(len(pattern)):
            j = r * len(pattern) + pos
            if isinstance(stack, dict):
                leaves = _flatten(stack[f"pos{pos}"], f"layers.{j}.")
                out.update((k, np.asarray(v)[r]) for k, v in leaves)
            else:
                out.update(_flatten(stack[j], f"layers.{j}."))
    out.update(_flatten(tree["final_norm"], "final_norm."))
    return out


def lm_params_from_numpy(cfg: ModelConfig, tree,
                         device: DeviceLike = None) -> LM:
    """The port's model holding the reference's parameters ``tree`` (numpy
    or array-like leaves, any float dtype), cast to ``cfg.params_dtype``."""
    dev = resolve_device(device)
    model = LM(cfg, None, dev)
    named = dict(model.named_parameters())
    flat = lm_named_from_tree(cfg, tree)
    if set(flat) != set(named):
        raise ValueError(f"parameter trees differ: only in the reference "
                         f"{sorted(set(flat) - set(named))}, only in the "
                         f"port {sorted(set(named) - set(flat))}")
    with torch.no_grad():
        for k, p in named.items():
            a = np.array(flat[k], np.float32)
            if a.shape != tuple(p.shape):
                raise ValueError(f"{k}: reference shape {a.shape}, port "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.from_numpy(a).to(dev))
    return model


def lm_grads_to_numpy(cfg: ModelConfig,
                      named: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """A name -> tensor dictionary over the model's parameters (its
    gradients, or an optimizer moment) as the reference's tree of float32
    numpy arrays, re-stacked into ``stack/pos{i}`` when
    ``cfg.scan_layers``."""
    prefix, pattern, n_rep = _stack_index(cfg)
    arrs = {k: t.detach().float().cpu().numpy() for k, t in named.items()}
    tree: Dict[str, Any] = {
        "embed": _unflatten(arrs, "embed."),
        "prefix": [dict(_layer_template(cfg, d),
                        **_unflatten(arrs, f"prefix.{i}."))
                   for i, d in enumerate(prefix)],
        "final_norm": _unflatten(arrs, "final_norm."),
    }
    layers = [dict(_layer_template(cfg, pattern[j % len(pattern)]),
                   **_unflatten(arrs, f"layers.{j}."))
              for j in range(n_rep * len(pattern))]
    if cfg.scan_layers:
        stack = {}
        for pos in range(len(pattern)):
            reps = [dict(_flatten(layers[r * len(pattern) + pos], ""))
                    for r in range(n_rep)]
            stacked = {k: np.stack([rep[k] for rep in reps]) for k in reps[0]}
            stack[f"pos{pos}"] = dict(_layer_template(cfg, pattern[pos]),
                                      **_unflatten(stacked, ""))
        tree["stack"] = stack
    else:
        tree["stack"] = layers
    return tree


def lm_params_to_numpy(cfg: ModelConfig, model: LM) -> Dict[str, Any]:
    """The model's parameters as the reference's tree (float32 numpy)."""
    return lm_grads_to_numpy(cfg, dict(model.named_parameters()))
