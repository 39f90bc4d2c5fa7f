"""yi-9b [dense] — llama-arch GQA [arXiv:2403.04652; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000,
    rope_theta=5e6, act="silu", norm_eps=1e-6,
    layer_pattern="g",
)
