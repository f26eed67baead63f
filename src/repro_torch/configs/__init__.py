"""Architecture registry: --arch <id> -> ModelConfig (exact published shapes)."""
from ..models.config import (ALL_SHAPES, DECODE_32K, LONG_500K, ModelConfig,
                             PREFILL_32K, ShapeSpec, TRAIN_4K, shape_by_name)

from .arctic_480b import CONFIG as ARCTIC_480B
from .llama4_maverick_400b_a17b import CONFIG as LLAMA4_MAVERICK
from .qwen3_32b import CONFIG as QWEN3_32B
from .mistral_nemo_12b import CONFIG as MISTRAL_NEMO_12B
from .qwen3_8b import CONFIG as QWEN3_8B
from .starcoder2_7b import CONFIG as STARCODER2_7B
from .jamba_1_5_large_398b import CONFIG as JAMBA_1_5_LARGE
from .mamba2_2_7b import CONFIG as MAMBA2_2_7B
from .seamless_m4t_large_v2 import CONFIG as SEAMLESS_M4T
from .chameleon_34b import CONFIG as CHAMELEON_34B

ARCHS = {
    c.name: c for c in (
        ARCTIC_480B, LLAMA4_MAVERICK, QWEN3_32B, MISTRAL_NEMO_12B, QWEN3_8B,
        STARCODER2_7B, JAMBA_1_5_LARGE, MAMBA2_2_7B, SEAMLESS_M4T,
        CHAMELEON_34B,
    )
}


def get_config(arch: str) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch]
