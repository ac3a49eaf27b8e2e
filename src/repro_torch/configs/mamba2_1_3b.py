"""mamba2-1.3b [ssm]: 48L d2048 attn-free vocab=50280, ssm_state=128.
SSD (state-space duality); FFN-less blocks.  [arXiv:2405.21060; unverified]
Data only; a copy of ``repro/configs/mamba2_1_3b.py``."""
from ..models.config import MambaConfig, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=64,          # d_inner / head_dim = 4096 / 64
    n_kv_heads=64,
    head_dim=64,
    d_ff=0,              # FFN-less: the SSD mixer is the whole block
    vocab=50280,
    mamba=MambaConfig(d_state=128, head_dim=64, expand=2, chunk=128),
)

SMOKE = ModelConfig(
    name="mamba2-smoke",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=0,
    vocab=256,
    mamba=MambaConfig(d_state=16, head_dim=32, expand=2, chunk=32),
    dtype="float32",
    param_dtype="float32",
)
