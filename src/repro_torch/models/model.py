"""Decoder-only LM of the architecture zoo, dense families (port of
``repro/models/model.py``).

A model is a prefix of layers plus a repeated *pattern* of layers
(``layer_descriptors``, copied exactly).  The port keeps every layer in one
``nn.ModuleList`` (``LM.layers``: repeat-major, pattern position minor),
whatever ``cfg.scan_layers`` says: the scan is a layout choice of JAX, and
``repro_torch.convert`` un-stacks the reference's ``stack/pos{i}`` leading
repeat dimension into these layers.

Attention + MLP layers (families dense, vlm, audio) and FFN-less Mamba2
layers (ssm: ``mamba.Mamba``, the SSD scan) are ported.  MoE and MLA
(moe) raise ``NotImplementedError`` at construction, and so does the
hybrid interleave (jamba's pattern holds MoE layers); ``ROADMAP.md``
(Queue 1) names the slices that bring them.  So do a KV cache and a mesh,
which come with the LM serving slice.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from . import layers as L
from .config import ModelConfig
from .mamba import Mamba


# ------------------------------------------------------------------ pattern
def layer_descriptors(cfg: ModelConfig) -> Tuple[List[dict], List[dict]]:
    """(prefix_descs, pattern_descs); layer i = prefix + repeats x pattern."""
    descs = []
    for i in range(cfg.n_layers):
        descs.append(
            {
                "kind": cfg.layer_kind(i),
                "moe": cfg.layer_is_moe(i),
                "mla": cfg.mla is not None and cfg.layer_kind(i) == "attn",
                # mamba2 is FFN-less (d_ff = 0): the mixer is the whole layer
                "ffn": cfg.layer_is_moe(i) or cfg.d_ff > 0,
            }
        )
    n_prefix = cfg.moe.first_dense if cfg.moe else 0
    prefix, rest = descs[:n_prefix], descs[n_prefix:]
    # find the shortest repeating pattern of `rest`
    plen = 1
    if cfg.hybrid is not None:
        plen = cfg.hybrid.period
    elif cfg.moe is not None and cfg.moe.layer_period > 1:
        plen = cfg.moe.layer_period
    assert len(rest) % plen == 0, (len(rest), plen)
    pattern = rest[:plen]
    for r in range(len(rest) // plen):
        assert rest[r * plen: (r + 1) * plen] == pattern, "pattern mismatch"
    return prefix, pattern


def _unported(desc: dict) -> Optional[str]:
    """Why the port cannot build a layer of ``desc`` yet, or None."""
    if desc["mla"] or desc["moe"]:
        return "MoE and MLA layers come with the MoE/MLA slice"
    return None


# ---------------------------------------------------------------- one layer
class Layer(nn.Module):
    """Pre-norm residual block: the mixer (attention, or Mamba2 for
    ``desc["kind"] == "mamba"``), then (if ``desc["ffn"]``) the MLP."""

    def __init__(self, cfg: ModelConfig, desc: dict,
                 gen: Optional[torch.Generator] = None, device=None):
        super().__init__()
        why = _unported(desc)
        if why is not None:
            raise NotImplementedError(f"{cfg.name}: {why}; see ROADMAP.md, "
                                      f"Queue 1")
        self.norm1 = L.Norm(cfg, device)
        self.is_mamba = desc["kind"] == "mamba"
        self.mixer = (Mamba(cfg, gen, device) if self.is_mamba
                      else L.Attention(cfg, gen, device))
        self.norm2 = self.ffn = None
        if desc["ffn"]:
            self.norm2 = L.Norm(cfg, device)
            self.ffn = L.MLP(cfg, gen, device)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        x = x + (self.mixer(h) if self.is_mamba else self.mixer(h, positions))
        if self.ffn is not None:
            x = x + self.ffn(self.norm2(x))
        return x


# -------------------------------------------------------------------- model
class LM(nn.Module):
    """Embedding, ``prefix`` layers, the repeated ``layers``, final norm."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        prefix, pattern = layer_descriptors(cfg)
        n_rep = (cfg.n_layers - len(prefix)) // len(pattern)
        self.embed = L.Embedding(cfg, gen, device)
        self.prefix = nn.ModuleList([Layer(cfg, d, gen, device)
                                     for d in prefix])
        self.layers = nn.ModuleList([Layer(cfg, d, gen, device)
                                     for _ in range(n_rep) for d in pattern])
        self.final_norm = L.Norm(cfg, device)


def init_model(cfg: ModelConfig, seed: int = 0,
               device: DeviceLike = None) -> LM:
    """The model with parameters drawn from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (default ``cuda``; without a card and
    without a device this raises) with the reference's distributions, not
    its ``jax.random`` values."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return LM(cfg, gen, dev)


def default_positions(cfg: ModelConfig, batch: int, s: int, offset=0,
                      device=None) -> torch.Tensor:
    off = torch.as_tensor(offset, dtype=torch.int64, device=device)
    if off.dim() == 0:
        off = off.expand(batch)
    pos = torch.arange(s, dtype=torch.int64, device=device)[None, :] + \
        off[:, None]
    if cfg.mrope_sections is not None:
        pos = pos[None].expand(3, batch, s)
    return pos


def forward_hidden(cfg: ModelConfig, model: LM, tokens: torch.Tensor,
                   positions: Optional[torch.Tensor] = None, cache=None,
                   input_embeds: Optional[torch.Tensor] = None,
                   mesh=None) -> Tuple[torch.Tensor, None]:
    """Final hidden states (B, S, D) of tokens (B, S), and ``None`` for the
    cache.  With ``cfg.remat`` every repeated layer runs under
    ``torch.utils.checkpoint`` (its activations are recomputed in the
    backward, as the reference's ``jax.checkpoint`` of the scan body), so
    only the layer inputs are kept."""
    if cache is not None or mesh is not None:
        raise NotImplementedError("forward_hidden with a cache or a mesh "
                                  "comes with the LM serving slice; see "
                                  "ROADMAP.md, Queue 1")
    b, s = tokens.shape
    if positions is None:
        positions = default_positions(cfg, b, s, 0, tokens.device)
    h = model.embed(tokens)
    if input_embeds is not None:
        h = h + input_embeds.to(h.dtype)
    for layer in model.prefix:
        h = layer(h, positions)
    for layer in model.layers:
        if cfg.remat:
            h = checkpoint(layer, h, positions, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            h = layer(h, positions)
    return model.final_norm(h), None


def logits_last(cfg: ModelConfig, model: LM,
                hidden: torch.Tensor) -> torch.Tensor:
    """(B, S, D) -> (B, vocab) float32 logits of the last position."""
    w = model.embed.unembed_matrix().to(cfg.activation_dtype)
    return torch.einsum("bd,dv->bv", hidden[:, -1], w).float()


def _chunk_loss(hc: torch.Tensor, lc: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    logits = torch.einsum("bsd,dv->bsv", hc, w).float()
    lz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lc.long()[..., None])[..., 0]
    return torch.sum(lz - gold)


def lm_loss(cfg: ModelConfig, model: LM, hidden: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token cross-entropy, chunked over sequence with each chunk
    checkpointed, so the (B, S, V) logits are never stored (V up to 202k)."""
    b, s, d = hidden.shape
    w = model.embed.unembed_matrix().to(cfg.activation_dtype)
    chunk = min(cfg.loss_chunk, s)
    assert s % chunk == 0
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(s // chunk):
        sl = slice(i * chunk, (i + 1) * chunk)
        total = total + checkpoint(_chunk_loss, hidden[:, sl], labels[:, sl],
                                   w, use_reentrant=False,
                                   preserve_rng_state=False)
    return total / (b * s)


def init_cache(*args, **kwargs):
    raise NotImplementedError("init_cache comes with the LM serving slice; "
                              "see ROADMAP.md, Queue 1")
