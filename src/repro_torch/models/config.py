"""Model configuration shared by all ten assigned architectures."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | ssm | moe | vlm | audio | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    qkv_bias: bool = False
    rope_theta: float = 1e6
    use_rope: bool = True        # jamba: no explicit positional encoding
    act: str = "silu"            # silu | gelu | relu
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    embed_scale: bool = False    # gemma: multiply embeddings by sqrt(d)
    zero_centered_norm: bool = False  # gemma: (1+scale) RMSNorm
    post_norms: bool = False     # gemma2: post-attn/post-mlp norms
    # layer pattern, tiled every len(layer_pattern) layers:
    #   'g' global attn, 'l' local (sliding window) attn, 'm' mamba, 'r' rwkv
    layer_pattern: str = "g"
    sliding_window: int = 4096
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    moe_every: int = 1           # layer i uses MoE iff i % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    router_renorm: bool = True
    # RWKV6
    rwkv_head_size: int = 64
    # Mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0       # 0 => d_model // 16
    # jamba2 (HF JambaMambaMixer): RMSNorms with learned scales on the
    # time step (dt_rank wide), B and C (d_state wide) after x_proj's split
    mamba_inner_norms: bool = False
    # encoder-decoder
    n_enc_layers: int = 0
    # modality frontend stubs ([vlm]/[audio]: backbone-only per spec)
    frontend: str = ""           # "" | "vit_stub" | "speech_stub"
    frontend_tokens: int = 0
    frontend_dim: int = 0

    @property
    def padded_vocab(self) -> int:
        """Embedding/lm-head rows padded for clean vocab sharding (multiple
        of 4096 covers model axes up to 4096; tiny test vocabs stay as-is
        when already divisible by 256)."""
        unit = 256 if self.vocab < 8192 else 4096
        return -(-self.vocab // unit) * unit

    @property
    def block_period(self) -> int:
        return len(self.layer_pattern)

    @property
    def n_blocks(self) -> int:
        assert self.n_layers % self.block_period == 0, \
            f"{self.name}: n_layers {self.n_layers} % pattern {self.layer_pattern}"
        return self.n_layers // self.block_period

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    @property
    def mamba_d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or max(1, self.d_model // 16)

    def layer_kind(self, layer_idx: int) -> str:
        return self.layer_pattern[layer_idx % self.block_period]

    def layer_is_moe(self, layer_idx: int) -> bool:
        return self.is_moe and layer_idx % self.moe_every == self.moe_offset

    def num_params(self) -> int:
        """Approximate parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab
        hd = self.head_dim
        n = v * d * (1 if self.tie_embeddings else 2)
        for i in range(self.n_layers):
            kind = self.layer_kind(i)
            if kind in ("g", "l"):
                n += d * hd * (self.n_heads + 2 * self.n_kv_heads)  # qkv
                n += self.n_heads * hd * d                           # out
            elif kind == "m":
                di, ds = self.mamba_d_inner, self.mamba_d_state
                n += d * 2 * di + di * d                   # in/out proj
                n += di * (self.dt_rank + 2 * ds)          # x_proj
                n += self.dt_rank * di                     # dt_proj
                n += di * (self.mamba_d_conv + ds + 2)     # conv, A, D, dt bias
                if self.mamba_inner_norms:
                    n += self.dt_rank + 2 * ds             # dt, B, C norms
            elif kind == "r":
                n += 6 * d * d        # r,k,v,g,o,w projections (approx, w/ lora)
            if self.layer_is_moe(i):
                n += self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
            elif kind != "r":
                n += 3 * d * dff
            else:
                n += 3 * d * dff      # rwkv channel mix ~ GLU-sized
        if self.is_encdec:  # encoder layers (self-attn + ffn) + cross-attn in dec
            for _ in range(self.n_enc_layers):
                n += d * hd * (self.n_heads + 2 * self.n_kv_heads)
                n += self.n_heads * hd * d + 3 * d * dff
            n += self.n_layers * (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                                  + self.n_heads * hd * d)
        return int(n)

    def num_active_params(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if not self.is_moe:
            return self.num_params()
        n = self.num_params()
        moe_layers = sum(1 for i in range(self.n_layers) if self.layer_is_moe(i))
        full = moe_layers * self.n_experts * 3 * self.d_model * self.d_ff_expert
        act = moe_layers * self.top_k * 3 * self.d_model * self.d_ff_expert
        return int(n - full + act)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    changes = dict(
        n_layers=cfg.block_period * 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab=256,
        name=cfg.name + "-reduced",
    )
    if cfg.is_moe:
        changes.update(n_experts=8, top_k=2, d_ff_expert=32)
    if cfg.n_enc_layers:
        changes.update(n_enc_layers=2)
    if cfg.frontend:
        changes.update(frontend_tokens=8, frontend_dim=32)
    if cfg.family == "ssm":
        changes.update(n_heads=4, head_dim=16)  # rwkv heads = d/head_size
        changes.update(rwkv_head_size=16)
    changes.update(overrides)
    return dataclasses.replace(cfg, **changes)
