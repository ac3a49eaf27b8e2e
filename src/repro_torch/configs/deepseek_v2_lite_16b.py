"""deepseek-v2-lite-16b [moe]: 27L d2048 16H d_ff=1408(expert) vocab=102400.
MLA kv_lora=512; 2 shared + 64 routed experts, top-6; first layer dense
(d_ff=10944).  [arXiv:2405.04434; hf]
Data only; a copy of ``repro/configs/deepseek_v2_lite_16b.py``."""
from ..models.config import MLAConfig, MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    n_layers=27,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=10944,          # the single dense layer
    vocab=102400,
    mla=MLAConfig(
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        n_experts=64,
        n_shared=2,
        top_k=6,
        expert_ff=1408,
        layer_period=1,
        first_dense=1,
    ),
)

SMOKE = ModelConfig(
    name="deepseek-smoke",
    family="moe",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=256,
    vocab=512,
    mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                  v_head_dim=16),
    moe=MoEConfig(n_experts=8, n_shared=2, top_k=2, expert_ff=64,
                  layer_period=1, first_dense=1),
    dtype="float32",
    param_dtype="float32",
)
