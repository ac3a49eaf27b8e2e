"""qwen3-1.7b [dense]: 28L d2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
qk_norm + GQA.  [hf:Qwen/Qwen3-8B; hf]
Data only; a copy of ``repro/configs/qwen3_1_7b.py``."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=6144,
    vocab=151936,
    qk_norm=True,
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    qk_norm=True,
    dtype="float32",
    param_dtype="float32",
)
