"""seamless-m4t-large-v2 [audio] — enc-dec, multimodal [arXiv:2308.11596; hf].

Backbone only per the assignment: the speech frontend is a STUB;
input_specs() supplies precomputed fbank frame embeddings (160-dim) that the
24-layer encoder consumes; the 24-layer decoder cross-attends.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=8192, vocab=256206,
    rope_theta=1e4, act="relu", norm_eps=1e-5,
    layer_pattern="g",
    n_enc_layers=24,
    frontend="speech_stub", frontend_dim=160,
)
