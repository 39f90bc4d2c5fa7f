"""Tiny configs for examples/tests (not part of the assigned pool)."""
from ..models.config import ModelConfig

TINY_DENSE = ModelConfig(
    name="tiny-dense", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab=256, layer_pattern="g",
)

TINY_MOE = ModelConfig(
    name="tiny-moe", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=64, vocab=256, layer_pattern="g",
    n_experts=8, top_k=2, d_ff_expert=64,
)
