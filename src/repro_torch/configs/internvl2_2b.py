"""internvl2-2b [vlm] — InternViT + InternLM2 [arXiv:2404.16821; hf].

Backbone only per the assignment: the InternViT frontend is a STUB;
input_specs() supplies precomputed patch embeddings (256 x 1024 per image)
projected into the LM width.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=92553,
    rope_theta=1e6, act="silu", norm_eps=1e-5,
    layer_pattern="g",
    frontend="vit_stub", frontend_tokens=256, frontend_dim=1024,
)
