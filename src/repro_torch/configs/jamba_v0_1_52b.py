"""jamba-v0.1-52b [hybrid] — Mamba+attn 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887; hf].

Period-8 block "mmmmgmmm" ('g'=attention at offset 4, attn_layer_period=8);
MoE on odd layers (expert_layer_offset=1, expert_layer_period=2).
No explicit positional encoding (Mamba provides position).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=65536,
    act="silu", norm_eps=1e-6, use_rope=False,
    layer_pattern="mmmmgmmm",
    n_experts=16, top_k=2, d_ff_expert=14336, moe_every=2, moe_offset=1,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2, mamba_dt_rank=256,
)
