"""Architecture registry: ``--arch <id>`` resolves here.

One module per assigned architecture (exact public configs), plus tiny
configs for tests/examples and ``reduced(cfg)`` for per-arch smoke tests.
"""
from __future__ import annotations

from typing import Dict, List

from ..models.config import SHAPES, ModelConfig, ShapeConfig, reduced
from .gemma2_9b import CONFIG as GEMMA2_9B
from .internvl2_2b import CONFIG as INTERNVL2_2B
from .jamba_v0_1_52b import CONFIG as JAMBA_V0_1_52B
from .olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from .qwen2_5_14b import CONFIG as QWEN2_5_14B
from .qwen2_7b import CONFIG as QWEN2_7B
from .qwen3_moe_30b_a3b import CONFIG as QWEN3_MOE_30B_A3B
from .rwkv6_7b import CONFIG as RWKV6_7B
from .seamless_m4t_large_v2 import CONFIG as SEAMLESS_M4T_LARGE_V2
from .tiny import TINY_DENSE, TINY_MOE
from .yi_9b import CONFIG as YI_9B

REGISTRY: Dict[str, ModelConfig] = {
    c.name: c for c in [
        QWEN2_7B, GEMMA2_9B, YI_9B, QWEN2_5_14B, RWKV6_7B,
        QWEN3_MOE_30B_A3B, OLMOE_1B_7B, INTERNVL2_2B,
        SEAMLESS_M4T_LARGE_V2, JAMBA_V0_1_52B, TINY_DENSE, TINY_MOE,
    ]
}

ASSIGNED: List[str] = [
    "qwen2-7b", "gemma2-9b", "yi-9b", "qwen2.5-14b", "rwkv6-7b",
    "qwen3-moe-30b-a3b", "olmoe-1b-7b", "internvl2-2b",
    "seamless-m4t-large-v2", "jamba-v0.1-52b",
]

# long_500k requires sub-quadratic attention: run only for SSM/hybrid.
SUBQUADRATIC: List[str] = ["rwkv6-7b", "jamba-v0.1-52b"]


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape '{name}'; known: {sorted(SHAPES)}")
    return SHAPES[name]


def cells(include_skips: bool = False):
    """All (arch, shape) dry-run cells; skips annotated."""
    out = []
    for arch in ASSIGNED:
        for shape in ["train_4k", "prefill_32k", "decode_32k", "long_500k"]:
            skip = ""
            if shape == "long_500k" and arch not in SUBQUADRATIC:
                skip = "full-attention arch: quadratic at 500k (DESIGN.md)"
            if skip and not include_skips:
                continue
            out.append((arch, shape, skip))
    return out


__all__ = ["REGISTRY", "ASSIGNED", "SUBQUADRATIC", "get_config", "get_shape",
           "cells", "reduced", "SHAPES"]
