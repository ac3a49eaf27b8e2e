"""Architecture registry: the 10 assigned archs, each selectable via
``--arch <id>``; per-arch input shapes (port of ``repro/configs``, data
only)."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..models.config import ModelConfig

from . import (
    deepseek_v2_lite_16b,
    jamba_1_5_large,
    llama4_maverick_400b,
    mamba2_1_3b,
    musicgen_medium,
    olmo_1b,
    qwen2_vl_7b,
    qwen3_1_7b,
    smollm_360m,
    stablelm_3b,
)

_MODULES = {
    "qwen3-1.7b": qwen3_1_7b,
    "olmo-1b": olmo_1b,
    "smollm-360m": smollm_360m,
    "stablelm-3b": stablelm_3b,
    "qwen2-vl-7b": qwen2_vl_7b,
    "musicgen-medium": musicgen_medium,
    "mamba2-1.3b": mamba2_1_3b,
    "deepseek-v2-lite-16b": deepseek_v2_lite_16b,
    "llama4-maverick-400b-a17b": llama4_maverick_400b,
    "jamba-1.5-large-398b": jamba_1_5_large,
}


def list_archs() -> List[str]:
    return list(_MODULES)


def get_config(name: str) -> ModelConfig:
    return _MODULES[name].CONFIG


def get_smoke_config(name: str) -> ModelConfig:
    return _MODULES[name].SMOKE


# --------------------------------------------------------------------- shapes
@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}

# long_500k needs a sub-quadratic sequence mixer: only the SSM / hybrid
# archs run it; pure full-attention archs skip (DESIGN.md §4).
_SUBQUADRATIC = {"mamba2-1.3b", "jamba-1.5-large-398b"}


def cell_supported(arch: str, shape: str) -> bool:
    if shape == "long_500k":
        return arch in _SUBQUADRATIC
    return True


def skip_reason(arch: str, shape: str) -> Optional[str]:
    if cell_supported(arch, shape):
        return None
    return (
        "full quadratic attention at 524k context is infeasible by design; "
        "shape runs only for SSM/hybrid archs (DESIGN.md §4)"
    )


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """(shape, dtype) of every model input (no allocation); the
    reference returns ``ShapeDtypeStruct``s of the same shapes.

    train:   tokens + labels (+ frontend embeddings for vlm/audio stubs)
    prefill: tokens
    decode:  one new token; the KV cache spec is built separately.
    """
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "train":
        specs = {"tokens": ((b, s), i32), "labels": ((b, s), i32)}
        if cfg.family in ("vlm", "audio"):
            # modality-frontend stub: precomputed patch/frame embeddings
            specs["input_embeds"] = ((b, s, cfg.d_model), cfg.activation_dtype)
        return specs
    if shape.kind == "prefill":
        specs = {"tokens": ((b, s), i32)}
        if cfg.family in ("vlm", "audio"):
            specs["input_embeds"] = ((b, s, cfg.d_model), cfg.activation_dtype)
        return specs
    # decode: one token per sequence; cache holds `seq_len` positions
    return {"tokens": ((b, 1), i32)}
