"""Decoder LM for the dense attention layer kinds (twin of
``repro.models.transformer``).

A model is a tiled stack of blocks, each instantiating
``cfg.layer_pattern`` ("g" global attention, "l" local sliding-window
attention). Parameters keep the reference's tree: blocks are stacked on a
leading ``n_blocks`` axis and sub-layers are named ``sub{i}``; the forward
pass loops over blocks in Python where the reference scans. Recurrent
("m", "r"), MoE, encoder-decoder and frontend models are not ported yet
and raise ``NotImplementedError``.

Matrices are stored in the compute dtype and norms and biases in fp32;
every use casts first, as the reference does, so the numerics are the
reference's. The decode cache is updated in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device
from .attention import attn_apply
from .config import ModelConfig
from .layers import embed, glu, rms_norm, truncated_normal_


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for what this port does not cover."""
    kinds = sorted(set(cfg.layer_pattern) - {"g", "l"})
    if kinds:
        raise NotImplementedError(f"{cfg.name}: layer kinds {kinds} are not "
                                  "ported yet")
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE is not ported yet")
    if cfg.is_encdec:
        raise NotImplementedError(f"{cfg.name}: encoder-decoder is not "
                                  "ported yet")
    if cfg.frontend:
        raise NotImplementedError(f"{cfg.name}: frontend {cfg.frontend!r} "
                                  "is not ported yet")


# ---------------------------------------------------------------- init

def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device: DeviceLike = None,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """Random parameters with the reference's distributions
    (truncated normal, stddev ``d_in ** -0.5``; embeddings stddev 1; zero
    biases; unit or zero-centred norms). Matrices in ``dtype``, norms and
    biases in fp32. ``generator`` must live on ``device``."""
    check_supported(cfg)
    device = resolve_device(device)
    d, hd, nb = cfg.d_model, cfg.head_dim, cfg.n_blocks
    f32 = dict(dtype=torch.float32, device=device)

    def mat(shape, stddev):
        t = torch.empty(shape, dtype=dtype, device=device)
        for part in (t if t.dim() == 3 else [t]):   # per block: bounded temp
            truncated_normal_(part, stddev, generator)
        return t

    def dense_p(d_in, d_out, bias=False, stddev=None):
        p = {"w": mat((nb, d_in, d_out),
                      stddev if stddev is not None else d_in ** -0.5)}
        if bias:
            p["b"] = torch.zeros((nb, d_out), **f32)
        return p

    def norm(*shape):
        return (torch.zeros if cfg.zero_centered_norm else torch.ones)(
            shape, **f32)

    blocks: Dict[str, Any] = {}
    for i, _kind in enumerate(cfg.layer_pattern):
        sub: Dict[str, Any] = {
            "ln1": norm(nb, d),
            "attn": {
                "wq": dense_p(d, cfg.n_heads * hd, cfg.qkv_bias),
                "wk": dense_p(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wv": dense_p(d, cfg.n_kv_heads * hd, cfg.qkv_bias),
                "wo": dense_p(cfg.n_heads * hd, d,
                              stddev=(cfg.n_heads * hd) ** -0.5),
            },
            "ln2": norm(nb, d),
            "ffn": {"wi": dense_p(d, cfg.d_ff), "wg": dense_p(d, cfg.d_ff),
                    "wo": dense_p(cfg.d_ff, d, stddev=cfg.d_ff ** -0.5)},
        }
        if cfg.post_norms:
            sub["post_ln1"] = norm(nb, d)
            sub["post_ln2"] = norm(nb, d)
        blocks[f"sub{i}"] = sub
    params: Dict[str, Any] = {
        "embed": {"table": mat((cfg.padded_vocab, d), 1.0)},
        "final_norm": norm(d),
        "blocks": blocks,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": mat((d, cfg.padded_vocab), d ** -0.5)}
    return params


# ---------------------------------------------------------------- cache

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               dtype: torch.dtype = torch.bfloat16,
               device: DeviceLike = None) -> Dict[str, Any]:
    """Stacked decode cache: {"sub{i}": {"k", "v"}} of
    [n_blocks, batch, max_len, n_kv_heads, head_dim]."""
    check_supported(cfg)
    device = resolve_device(device)
    shape = (cfg.n_blocks, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {f"sub{i}": {"k": torch.zeros(shape, dtype=dtype, device=device),
                        "v": torch.zeros(shape, dtype=dtype, device=device)}
            for i in range(cfg.block_period)}


def cache_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes for the cache tree (same structure as init_cache)."""
    axes = ("layers", "batch", "cache_seq", "kv_heads", None)
    return {f"sub{i}": {"k": axes, "v": axes}
            for i in range(cfg.block_period)}


# ---------------------------------------------------------------- forward

def _block(tree: Any, i: int) -> Any:
    """Views of block ``i`` of a tree stacked on the leading axis."""
    if isinstance(tree, dict):
        return {k: _block(v, i) for k, v in tree.items()}
    return tree[i]


def forward(params, cfg: ModelConfig, *, tokens: torch.Tensor,
            positions: Optional[torch.Tensor] = None, cache=None,
            lengths: Optional[torch.Tensor] = None,
            impl: Optional[str] = None,
            compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Any]:
    """Run the decoder stack. Returns (hidden [B,S,D], the cache|None)."""
    check_supported(cfg)
    x = embed(tokens, params["embed"], scale_by_dim=cfg.embed_scale,
              compute_dtype=compute_dtype)
    S = x.shape[1]
    if positions is None:
        positions = (torch.arange(S, device=x.device)
                     if lengths is None or S > 1 else (lengths - 1)[:, None])
    zc, eps = cfg.zero_centered_norm, cfg.norm_eps
    for blk in range(cfg.n_blocks):
        for i, kind in enumerate(cfg.layer_pattern):
            sub = _block(params["blocks"][f"sub{i}"], blk)
            c = (None if cache is None else
                 {"k": cache[f"sub{i}"]["k"][blk],
                  "v": cache[f"sub{i}"]["v"][blk]})
            h = rms_norm(x, sub["ln1"], eps, zc)
            out, _ = attn_apply(sub["attn"], h, cfg=cfg, kind=kind,
                                positions=positions, cache=c,
                                lengths=lengths, impl=impl,
                                compute_dtype=compute_dtype)
            if cfg.post_norms:
                out = rms_norm(out, sub["post_ln1"], eps, zc)
            x = x + out
            h = rms_norm(x, sub["ln2"], eps, zc)
            out = glu(h, sub["ffn"], cfg.act, compute_dtype)
            if cfg.post_norms:
                out = rms_norm(out, sub["post_ln2"], eps, zc)
            x = x + out
    x = rms_norm(x, params["final_norm"], eps, zc)
    return x, cache


def logits_head(params, cfg: ModelConfig, h: torch.Tensor,
                compute_dtype=torch.bfloat16) -> torch.Tensor:
    """fp32 logits with the final softcap; padded vocab rows are -1e30."""
    w = (params["embed"]["table"].T if cfg.tie_embeddings
         else params["lm_head"]["w"])
    logits = (h.to(compute_dtype) @ w.to(compute_dtype)).float()
    if cfg.final_softcap > 0:
        logits = torch.tanh(logits / cfg.final_softcap) * cfg.final_softcap
    if cfg.padded_vocab != cfg.vocab:   # mask padding rows out of the softmax
        logits[..., cfg.vocab:] = -1e30
    return logits


def prefill(params, cfg: ModelConfig, tokens: torch.Tensor, cache, *,
            lengths: Optional[torch.Tensor] = None,
            impl: Optional[str] = None, compute_dtype=torch.bfloat16):
    """Fill the cache with S tokens; return (last-token logits, cache,
    lengths). ``lengths`` ([B] int32, optional) marks per-row true prompt
    lengths of right-padded rows: logits are gathered at each row's last
    valid position."""
    B, S = tokens.shape
    h, cache = forward(params, cfg, tokens=tokens, cache=cache, impl=impl,
                       compute_dtype=compute_dtype)
    if lengths is None:
        lengths = torch.full((B,), S, dtype=torch.int32, device=h.device)
        h_last = h[:, -1:]
    else:
        lengths = lengths.to(device=h.device, dtype=torch.int32)
        idx = (lengths - 1).clamp(0, S - 1).long()
        h_last = h.gather(1, idx[:, None, None].expand(B, 1, h.shape[-1]))
    return logits_head(params, cfg, h_last, compute_dtype), cache, lengths


def decode_step(params, cfg: ModelConfig, tokens: torch.Tensor, cache,
                lengths: torch.Tensor, *, impl: Optional[str] = None,
                compute_dtype=torch.bfloat16):
    """One decode step. tokens [B,1]; lengths [B] = position+1 of the new
    token. Returns (logits [B,1,V], cache, lengths + 1)."""
    h, cache = forward(params, cfg, tokens=tokens, cache=cache,
                       lengths=lengths, impl=impl,
                       compute_dtype=compute_dtype)
    return logits_head(params, cfg, h, compute_dtype), cache, lengths + 1
