"""qwen2-vl-7b [vlm]: 28L d3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
M-RoPE + dynamic resolution; the vision frontend is a STUB — input_specs
provides precomputed patch embeddings.  [arXiv:2409.12191; hf]
Data only; a copy of ``repro/configs/qwen2_vl_7b.py``."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    head_dim=128,
    d_ff=18944,
    vocab=152064,
    mrope_sections=(16, 24, 24),
    rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen2-vl-smoke",
    family="vlm",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    mrope_sections=(4, 6, 6),
    dtype="float32",
    param_dtype="float32",
)
