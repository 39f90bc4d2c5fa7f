"""rwkv6-7b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892; hf]. 64 heads of head_size 64 (d_model 4096)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab=65536,
    layer_pattern="r", rwkv_head_size=64,
    use_rope=False,
)
