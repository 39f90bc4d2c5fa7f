"""gemma2-9b [dense] — local+global alternating, logit softcap
[arXiv:2408.00118; hf]. Local (sliding-window 4096) layers on even indices.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000,
    rope_theta=1e4, act="gelu", norm_eps=1e-6,
    layer_pattern="lg", sliding_window=4096,
    attn_softcap=50.0, final_softcap=30.0,
    post_norms=True, zero_centered_norm=True, embed_scale=True,
    tie_embeddings=True,
)
