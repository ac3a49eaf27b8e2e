"""olmo-1b [dense]: 16L d2048 16H (kv=16) d_ff=8192 vocab=50304.
Non-parametric LayerNorm.  [arXiv:2402.00838; hf]
Data only; a copy of ``repro/configs/olmo_1b.py``."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmo-1b",
    family="dense",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=8192,
    vocab=50304,
    norm_type="nonparam_ln",
)

SMOKE = ModelConfig(
    name="olmo-smoke",
    family="dense",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab=512,
    norm_type="nonparam_ln",
    dtype="float32",
    param_dtype="float32",
)
