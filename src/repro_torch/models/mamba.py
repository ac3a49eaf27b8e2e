"""Mamba2 (SSD) mixer block (port of ``repro/models/mamba.py``).

Projections follow the Mamba2 layout: in_proj -> [z, x, B, C, dt]; a short
depthwise causal conv over (x, B, C); the SSD scan (``kernels.ssd.ssd``:
the ``csrc/ssd.cu`` kernel on the card, the plain chunked scan on the
CPU); gated RMSNorm; out_proj.  One B and one C are broadcast over all
heads (``expand``, read by the kernel through a head stride of 0).

Parameters keep the reference's leaves and layouts (``w_in`` (d, 2 di +
2 N + H), ``conv_w`` (width, di + 2 N), ``a_log``, ``dt_bias``, ``d_skip``
(H,) float32, ``norm_w`` (di,), ``w_out`` (di, d)), so they carry across
leaf for leaf (``repro_torch.convert``).  Dtypes follow the reference: the
projections and ``x * dt`` in the activation dtype, softplus and the
decays in float32, the skip and the gate in the activation dtype.

Not ported yet (they come with the LM serving slice, ROADMAP.md Queue 1):
the cache branch of the forward (prefill from a state, one-token decode)
and ``init_mamba_cache``.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..kernels.ssd import ops as sops
from .config import ModelConfig
from .layers import _normal, dense_init, rms_norm

_SERVING = ("comes with the LM serving slice (caches, prefill and decode); "
            "see ROADMAP.md, Queue 1")


def _conv_channels(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.mamba.d_state


def _split_in(cfg: ModelConfig, proj: torch.Tensor):
    di, n = cfg.d_inner, cfg.mamba.d_state
    z = proj[..., :di]
    xbc = proj[..., di: di + di + 2 * n]
    dt = proj[..., di + di + 2 * n:]
    return z, xbc, dt


def _causal_conv(cfg: ModelConfig, xbc: torch.Tensor,
                 conv_w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, from a zero state, then SiLU.
    xbc: (B, S, C), in float32 sums cast back to xbc's dtype."""
    width = cfg.mamba.conv_width
    pad = torch.zeros((xbc.shape[0], width - 1, xbc.shape[2]),
                      dtype=xbc.dtype, device=xbc.device)
    xp = torch.cat([pad, xbc], dim=1)                   # (B, S+w-1, C)
    wf = conv_w.float()
    out = sum(xp[:, i: i + xbc.shape[1]].float() * wf[i][None, None]
              for i in range(width))
    return nn.functional.silu(out).to(xbc.dtype)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``jax.nn.softplus`` computes it, ``logaddexp(x,
    0)``, without ``F.softplus``'s switch to x above a threshold."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


class Mamba(nn.Module):
    """The Mamba2 mixer: (B, S, d) -> (B, S, d), without a cache."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        mc = cfg.mamba
        d, di, n = cfg.d_model, cfg.d_inner, mc.d_state
        h = cfg.n_mamba_heads
        dt = cfg.params_dtype
        f32 = dict(dtype=torch.float32, device=device)
        self.w_in = dense_init(gen, d, (d, 2 * di + 2 * n + h), dt, device)
        self.conv_w = nn.Parameter(_normal(
            gen, (mc.conv_width, _conv_channels(cfg)), dt, 0.1, device))
        self.a_log = nn.Parameter(torch.log(torch.linspace(1.0, 16.0, h,
                                                           **f32)))
        self.dt_bias = nn.Parameter(torch.zeros(h, **f32))
        self.d_skip = nn.Parameter(torch.ones(h, **f32))
        self.norm_w = nn.Parameter(torch.ones(di, dtype=dt, device=device))
        self.w_out = dense_init(gen, di, (di, d), dt, device)

    def forward(self, x: torch.Tensor, cache=None) -> torch.Tensor:
        if cache is not None:
            raise NotImplementedError(f"the Mamba forward with a cache "
                                      f"{_SERVING}")
        cfg = self.cfg
        mc = cfg.mamba
        dt_act = cfg.activation_dtype
        b, s, _ = x.shape
        di, n, h = cfg.d_inner, mc.d_state, cfg.n_mamba_heads

        proj = torch.einsum("bsd,dk->bsk", x, self.w_in.to(dt_act))
        z, xbc, dt_raw = _split_in(cfg, proj)
        xbc = _causal_conv(cfg, xbc, self.conv_w)
        xin = xbc[..., :di]
        b_in = xbc[..., di: di + n]
        c_in = xbc[..., di + n:]

        dt = softplus(dt_raw.float() + self.dt_bias)               # (B,S,H)
        a_decay = torch.exp(-torch.exp(self.a_log)[None, None] * dt)

        xh = xin.reshape(b, s, h, mc.head_dim)
        # dt scales the input branch (standard Mamba2 discretization)
        xh = xh * dt[..., None].to(xh.dtype)
        bh = b_in[:, :, None, :].expand(b, s, h, n)
        ch = c_in[:, :, None, :].expand(b, s, h, n)
        y, _ = sops.ssd(xh, a_decay, bh, ch, chunk=min(mc.chunk, s))

        y = y + xh * self.d_skip[None, None, :, None].to(y.dtype)
        y = y.reshape(b, s, di).to(dt_act)
        # the gate in the activation dtype, as the reference
        y = rms_norm(y * nn.functional.silu(z), self.norm_w)
        return torch.einsum("bsk,kd->bsd", y, self.w_out.to(dt_act))


def init_mamba_cache(*args, **kwargs):
    raise NotImplementedError(f"init_mamba_cache {_SERVING}")

