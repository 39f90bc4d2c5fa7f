"""qwen3-moe-30b-a3b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=768, vocab=151936,
    rope_theta=1e6, act="silu", norm_eps=1e-6,
    layer_pattern="g",
    n_experts=128, top_k=8, d_ff_expert=768, moe_every=1,
    router_renorm=True,
)
