"""Model configuration for the architecture zoo (port of
``repro/models/config.py``).

One dataclass covers all 10 assigned families; family-specific blocks are
selected by ``family`` + the optional sub-configs.  Exact per-arch values
live in ``repro_torch.configs.<id>``.  The dataclasses are the reference's
field for field; ``activation_dtype`` / ``params_dtype`` return
``torch.dtype``s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    n_shared: int = 0          # always-on shared experts (DeepSeek style)
    top_k: int = 2
    expert_ff: int = 1024      # per-expert hidden size
    layer_period: int = 1      # MoE every `period` layers (others dense)
    first_dense: int = 0       # first N layers stay dense (DeepSeek: 1)
    capacity_factor: float = 1.25


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0       # 0 = full-rank queries (v2-lite)
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 128
    head_dim: int = 64         # P; heads = d_inner / head_dim
    expand: int = 2
    chunk: int = 128
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Jamba-style interleave: one attention layer per `period` layers."""
    period: int = 8
    attn_index: int = 3        # position of the attention layer in a period


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    qk_norm: bool = False
    norm_type: str = "rms"     # rms | nonparam_ln (OLMo)
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, int, int]] = None  # Qwen2-VL M-RoPE
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    hybrid: Optional[HybridConfig] = None
    # execution
    dtype: str = "bfloat16"     # activations/params compute dtype
    param_dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 256       # query-chunked attention threshold block
    loss_chunk: int = 512       # sequence chunking for the vocab loss
    # sharding knobs (see models/sharding.py)
    fsdp: bool = True           # shard param embed-dim over the data axis
    seq_shard_decode: bool = True  # shard KV cache sequence dim over model
    # sequence parallelism for the layer-boundary activations saved by the
    # scan-over-layers for backward: sharded over "model" between layers,
    # re-gathered inside each layer (8-16x less activation memory).
    seq_shard_activations: bool = True
    attn_bytes_budget: int = 1 << 29  # per-tensor budget for chunked attention

    @property
    def activation_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def params_dtype(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    @property
    def d_inner(self) -> int:
        assert self.mamba is not None
        return self.mamba.expand * self.d_model

    @property
    def n_mamba_heads(self) -> int:
        return self.d_inner // self.mamba.head_dim

    def layer_kind(self, i: int) -> str:
        """'attn' or 'mamba' mixer for layer i."""
        if self.family in ("ssm",):
            return "mamba"
        if self.family == "hybrid":
            return "attn" if (i % self.hybrid.period) == self.hybrid.attn_index else "mamba"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if self.moe is None:
            return False
        if i < self.moe.first_dense:
            return False
        return ((i - self.moe.first_dense) % self.moe.layer_period) == 0

    def param_count(self) -> int:
        """Rough total parameter count (for 6ND roofline math)."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            if self.layer_kind(i) == "attn":
                if self.mla is not None:
                    m = self.mla
                    qd = self.n_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                    total += d * qd                       # q proj
                    total += d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    total += m.kv_lora_rank * self.n_heads * (
                        m.qk_nope_head_dim + m.v_head_dim
                    )
                    total += self.n_heads * m.v_head_dim * d
                else:
                    total += d * self.n_heads * self.head_dim * 2
                    total += d * self.n_kv_heads * self.head_dim * 2
            else:
                mi = self.d_inner
                n = self.mamba.d_state
                h = self.n_mamba_heads
                total += d * (2 * mi + 2 * n * 1 + h)     # in_proj(x,z)+B,C+dt
                total += mi * d                            # out_proj
            if self.layer_is_moe(i):
                mo = self.moe
                total += (mo.n_experts + mo.n_shared) * 3 * d * mo.expert_ff
                total += d * mo.n_experts                  # router
            else:
                total += 3 * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        mo = self.moe
        total = self.param_count()
        n_moe_layers = sum(self.layer_is_moe(i) for i in range(self.n_layers))
        inactive = (mo.n_experts - mo.top_k) * 3 * d * mo.expert_ff
        return total - n_moe_layers * inactive
