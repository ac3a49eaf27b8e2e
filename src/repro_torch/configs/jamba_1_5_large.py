"""jamba-1.5-large-398b [hybrid]: 72L d8192 64H (GQA kv=8) d_ff=24576
vocab=65536, MoE 16 experts top-2; Mamba:attention 7:1 interleave (one attn
layer per 8, at index 3), MoE every other layer.  [arXiv:2403.19887; hf]
Data only; a copy of ``repro/configs/jamba_1_5_large.py``."""
from ..models.config import HybridConfig, MambaConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab=65536,
    mamba=MambaConfig(d_state=128, head_dim=64, expand=2, chunk=128),
    hybrid=HybridConfig(period=8, attn_index=3),
    moe=MoEConfig(n_experts=16, n_shared=0, top_k=2, expert_ff=24576,
                  layer_period=2),
)

SMOKE = ModelConfig(
    name="jamba-smoke",
    family="hybrid",
    n_layers=8,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=256,
    mamba=MambaConfig(d_state=16, head_dim=16, expand=2, chunk=32),
    hybrid=HybridConfig(period=4, attn_index=3),
    moe=MoEConfig(n_experts=4, top_k=2, expert_ff=128, layer_period=2),
    dtype="float32",
    param_dtype="float32",
)
