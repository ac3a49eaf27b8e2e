"""llama4-maverick-400b-a17b [moe]: 48L d5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 128 experts top-1 + shared, interleaved every other layer.
Early-fusion multimodal — text backbone only (frontend stubbed).
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]
Data only; a copy of ``repro/configs/llama4_maverick_400b.py``."""
from ..models.config import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab=202048,
    rope_theta=5e5,
    moe=MoEConfig(
        n_experts=128,
        n_shared=1,
        top_k=1,
        expert_ff=8192,
        layer_period=2,   # MoE every other layer
    ),
)

SMOKE = ModelConfig(
    name="llama4-smoke",
    family="moe",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab=512,
    moe=MoEConfig(n_experts=8, n_shared=1, top_k=1, expert_ff=128,
                  layer_period=2),
    dtype="float32",
    param_dtype="float32",
)
