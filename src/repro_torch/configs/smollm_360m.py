"""smollm-360m [dense]: 32L d960 15H (GQA kv=5) d_ff=2560 vocab=49152.
Llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M; hf]
Data only; a copy of ``repro/configs/smollm_360m.py``."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    head_dim=64,
    d_ff=2560,
    vocab=49152,
)

SMOKE = ModelConfig(
    name="smollm-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=3,
    n_kv_heads=1,
    head_dim=32,
    d_ff=192,
    vocab=512,
    dtype="float32",
    param_dtype="float32",
)
