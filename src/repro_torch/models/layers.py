"""Shared neural layers: norms, RoPE/M-RoPE, embeddings, attention, MLP
(port of ``repro/models/layers.py``).

Parameters keep the reference's einsum layouts (``wq`` (d, h, hd), ``wo``
(h, hd, d), ``wg`` (d, f), the embedding ``table`` (V, d) and ``unembed``
(d, V)), so a parameter pytree carries across leaf for leaf
(``repro_torch.convert.lm_params_from_numpy``).  Each module's constructor
draws its parameters from an explicit ``torch.Generator`` with the
reference's distributions and scales (normal * d_in^-0.5 for projections,
* 0.02 for the table, ones for norm weights); without a generator the
parameters are left uninitialised, to be filled by the converter.

Dtypes follow the reference: products in the activation dtype (bf16
``torch.matmul``s on the card, plain library products as the reference
leaves them to XLA), norms and RoPE in float32 cast back, ``silu(g) * u``
in the activation dtype.

Not ported yet (they come with the LM serving slice, ROADMAP.md Queue 1):
the KV-cache branch of ``attention_forward``, ``sharded_decode_attention``
and the cache initialisers.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.attention import ops as aops
from .config import ModelConfig

_SERVING = ("comes with the LM serving slice (KV caches, prefill and "
            "decode); see ROADMAP.md, Queue 1")


# ---------------------------------------------------------------- init utils
def _normal(gen: Optional[torch.Generator], shape, dtype, scale: float,
            device) -> torch.Tensor:
    """normal(0, 1) * scale drawn in float32 and cast, as the reference's
    ``_normal``; uninitialised without a generator."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (x * scale).to(dtype)


def dense_init(gen, d_in: int, shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(_normal(gen, shape, dtype, d_in ** -0.5, device))


# --------------------------------------------------------------------- norms
def rms_norm(x: torch.Tensor, weight: Optional[torch.Tensor],
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    return out.to(x.dtype)


def nonparam_layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo-style non-parametric LayerNorm (no scale/bias)."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def apply_norm(cfg: ModelConfig, x: torch.Tensor,
               weight: Optional[torch.Tensor]) -> torch.Tensor:
    if cfg.norm_type == "nonparam_ln":
        return nonparam_layer_norm(x)
    return rms_norm(x, weight)


class Norm(nn.Module):
    """The layer norm of ``cfg.norm_type``: RMSNorm with a weight ``w``
    (d,) of ones, or OLMo's non-parametric LayerNorm with none."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.w = (None if cfg.norm_type == "nonparam_ln" else nn.Parameter(
            torch.ones(cfg.d_model, dtype=cfg.params_dtype, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return apply_norm(self.cfg, x, self.w)


# ---------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, int, int]] = None
               ) -> torch.Tensor:
    """x (B, H, S, D); positions (B, S), or (3, B, S) for M-RoPE."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                     # (D/2,)
    if mrope_sections is None:
        ang = positions.float()[:, None, :, None] * inv      # (B,1,S,D/2)
    else:
        # M-RoPE (Qwen2-VL): the D/2 frequency slots are split into
        # (temporal, height, width) sections, each driven by its own
        # position stream.  positions: (3, B, S).
        secs = mrope_sections
        assert sum(secs) == d // 2, (secs, d)
        sel = torch.cat([torch.full((s,), i, dtype=torch.int64,
                                    device=x.device)
                         for i, s in enumerate(secs)])        # (D/2,)
        pos_per_slot = positions.float()[sel]                 # (D/2, B, S)
        ang = torch.movedim(pos_per_slot, 0, -1)[:, None, :, :] * inv
    sin, cos = torch.sin(ang), torch.cos(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, chunk: int,
                             scale: float) -> torch.Tensor:
    """Online-softmax attention over query chunks — O(S * chunk) memory.
    q: (B,H,S,D); k/v: (B,KVH,S,D).  The CPU's path for long sequences
    (the card runs the flash kernel); each chunk is checkpointed, so its
    (B,H,chunk,S) scores are recomputed in the backward, never stored
    across chunks, as the reference's ``jax.checkpoint`` body."""
    b, h, s, d = q.shape
    dv = v.shape[-1]  # MLA: value dim may differ from q/k dim
    kvh = k.shape[1]
    g = h // kvh
    kf = k.float()
    vf = v.float()
    cols = torch.arange(s, dtype=torch.int64, device=q.device)

    def body(qc: torch.Tensor, qi: int) -> torch.Tensor:
        qg = qc.float().reshape(b, kvh, g, chunk, d)
        sc = torch.einsum("bhgqd,bhkd->bhgqk", qg * scale, kf)
        rows = qi * chunk + torch.arange(chunk, dtype=torch.int64,
                                         device=q.device)
        sc = torch.where(rows[:, None] >= cols[None, :], sc, -1e30)
        p = torch.softmax(sc, dim=-1)
        o = torch.einsum("bhgqk,bhkd->bhgqd", p, vf)
        return o.reshape(b, h, chunk, dv).to(q.dtype)

    outs = [checkpoint(body, q[:, :, i * chunk:(i + 1) * chunk], i,
                       use_reentrant=False, preserve_rng_state=False)
            for i in range(s // chunk)]
    return torch.cat(outs, dim=2)


def attention_core(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor, *, kv_len: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Dispatch, as the reference's on a TPU: every cacheless attention on
    the card goes to the flash kernel (``aops.mha``).  On the CPU a long
    sequence takes the query-chunked path, the rest ``mha_ref``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    b, h, s, _ = q.shape
    if kv_len is None and s > cfg.attn_chunk and q.device.type == "cpu":
        # adapt the query-chunk so the (B,H,chunk,S) f32 score tensor stays
        # inside the byte budget even for replicated-head configs
        chunk = cfg.attn_chunk
        while chunk > 64 and b * h * chunk * s * 4 > cfg.attn_bytes_budget:
            chunk //= 2
        while s % chunk:
            chunk //= 2
        return chunked_causal_attention(q, k, v, chunk, scale)
    return aops.mha(q, k, v, causal=True, kv_len=kv_len, scale=scale)


class Attention(nn.Module):
    """GQA self-attention with optional qk-norm and (M-)RoPE."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        dt = cfg.params_dtype
        self.wq = dense_init(gen, d, (d, h, hd), dt, device)
        self.wk = dense_init(gen, d, (d, kvh, hd), dt, device)
        self.wv = dense_init(gen, d, (d, kvh, hd), dt, device)
        self.wo = dense_init(gen, h * hd, (h, hd, d), dt, device)
        if cfg.qk_norm:
            self.q_norm = nn.Parameter(torch.ones(hd, dtype=dt, device=device))
            self.k_norm = nn.Parameter(torch.ones(hd, dtype=dt, device=device))
        else:
            self.q_norm = self.k_norm = None

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                cache=None, mesh=None) -> torch.Tensor:
        """x (B, S, D) -> (B, S, D), without a cache."""
        if cache is not None or mesh is not None:
            raise NotImplementedError(f"attention with a cache or mesh "
                                      f"{_SERVING}")
        cfg = self.cfg
        dt = cfg.activation_dtype
        q = torch.einsum("bsd,dhk->bhsk", x, self.wq.to(dt))
        k = torch.einsum("bsd,dhk->bhsk", x, self.wk.to(dt))
        v = torch.einsum("bsd,dhk->bhsk", x, self.wv.to(dt))
        if cfg.qk_norm:
            q = rms_norm(q, self.q_norm)
            k = rms_norm(k, self.k_norm)
        q = apply_rope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = apply_rope(k, positions, cfg.rope_theta, cfg.mrope_sections)
        o = attention_core(cfg, q, k, v)
        return torch.einsum("bhsk,hkd->bsd", o, self.wo.to(dt))


def sharded_decode_attention(*args, **kwargs):
    raise NotImplementedError(f"sharded_decode_attention {_SERVING}")


def init_attention_cache(*args, **kwargs):
    raise NotImplementedError(f"init_attention_cache {_SERVING}")


# ----------------------------------------------------------------------- MLP
class MLP(nn.Module):
    """SwiGLU feed-forward: wd(silu(x wg) * (x wu))."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None, d_ff: Optional[int] = None):
        super().__init__()
        self.cfg = cfg
        f = d_ff or cfg.d_ff
        d = cfg.d_model
        dt = cfg.params_dtype
        self.wg = dense_init(gen, d, (d, f), dt, device)
        self.wu = dense_init(gen, d, (d, f), dt, device)
        self.wd = dense_init(gen, f, (f, d), dt, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.cfg.activation_dtype
        g = torch.einsum("bsd,df->bsf", x, self.wg.to(dt))
        u = torch.einsum("bsd,df->bsf", x, self.wu.to(dt))
        h = nn.functional.silu(g) * u  # in the activation dtype, as the reference
        return torch.einsum("bsf,fd->bsd", h, self.wd.to(dt))


# ---------------------------------------------------------------- embeddings
class Embedding(nn.Module):
    """Token table (V, d) and, untied, the unembedding (d, V)."""

    def __init__(self, cfg: ModelConfig, gen: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        dt = cfg.params_dtype
        self.table = nn.Parameter(_normal(gen, (cfg.vocab, cfg.d_model), dt,
                                          0.02, device))
        self.unembed = (None if cfg.tie_embeddings else dense_init(
            gen, cfg.d_model, (cfg.d_model, cfg.vocab), dt, device))

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.table.to(self.cfg.activation_dtype)[tokens.long()]

    def unembed_matrix(self) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return self.table.T
        return self.unembed
