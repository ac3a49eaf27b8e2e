"""stablelm-3b [dense]: 32L d2560 32H (kv=32) d_ff=6912 vocab=50304.
[hf:stabilityai/stablelm-2-1_6b; unverified]
Data only; a copy of ``repro/configs/stablelm_3b.py``."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    n_layers=32,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab=50304,
)

SMOKE = ModelConfig(
    name="stablelm-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab=512,
    dtype="float32",
    param_dtype="float32",
)
