"""musicgen-medium [audio]: 48L d1536 24H (kv=24) d_ff=6144 vocab=2048.
Decoder-only over EnCodec tokens; the EnCodec frontend is a STUB —
input_specs provides precomputed frame embeddings.  [arXiv:2306.05284; hf]
Data only; a copy of ``repro/configs/musicgen_medium.py``."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    family="audio",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv_heads=4,
    head_dim=32,
    d_ff=256,
    vocab=256,
    dtype="float32",
    param_dtype="float32",
)
