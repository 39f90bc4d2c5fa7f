"""olmoe-1b-7b [moe] — 64 experts top-8 [arXiv:2409.02060; hf]. kv=16 => MHA."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=1024, vocab=50304,
    rope_theta=1e4, act="silu", norm_eps=1e-5,
    layer_pattern="g",
    n_experts=64, top_k=8, d_ff_expert=1024, moe_every=1,
    router_renorm=False,
)
