"""GQA attention block (twin of ``repro.models.attention``): QKV bias, GQA,
RoPE, sliding window on "l" layers, logit softcap, single-token decode
against a KV cache, bidirectional attention (the encoder) and
cross-attention (the seamless decoder, K/V from the encoder output).

Unlike the reference, which returns a new cache, the cache tensors are
updated in place (the engine preallocates them once); the returned dict
holds the same tensors.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..kernels.flash_attention import ops as attn_ops
from .config import ModelConfig
from .layers import dense, rope


def attn_apply(p: Dict[str, Any], x: torch.Tensor, *, cfg: ModelConfig,
               kind: str = "g", positions: Optional[torch.Tensor] = None,
               causal: bool = True, kv_x: Optional[torch.Tensor] = None,
               cache: Optional[Dict[str, torch.Tensor]] = None,
               lengths: Optional[torch.Tensor] = None,
               impl: Optional[str] = None,
               compute_dtype=torch.bfloat16
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Self or cross attention. x: [B, S, D]. kv_x: the encoder output for
    cross-attention (K/V from it, no RoPE, no cache update); with a cache
    as well, K/V are the cache's precomputed cross K/V and ``kv_x`` is
    not read. cache: {"k","v"} [B, L, KV, hd], with ``lengths`` [B] =
    #valid tokens incl. the current one (self-attention decode). Returns
    (out [B, S, D], the cache or None)."""
    if kind not in ("g", "l"):
        raise NotImplementedError(f"attention layer kind {kind!r}")
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.sliding_window if kind == "l" else 0
    q = dense(x, p["wq"], compute_dtype).reshape(B, S, H, hd)
    is_cross = kv_x is not None
    if is_cross and cache is not None:
        # decode-time cross attention: K/V precomputed at prefill
        if cache["k"].shape[1] == 0:
            raise ValueError(
                "cross-attention against a cache with enc_len 0: build the "
                "cache with enc_len > 0, or prefill with frames")
        out = attn_ops.mha(q, cache["k"], cache["v"], causal=False,
                           softcap=cfg.attn_softcap, impl=impl)
        return dense(out.reshape(B, S, H * hd), p["wo"], compute_dtype), cache
    src = kv_x if is_cross else x
    Skv = src.shape[1]
    k = dense(src, p["wk"], compute_dtype).reshape(B, Skv, KV, hd)
    v = dense(src, p["wv"], compute_dtype).reshape(B, Skv, KV, hd)
    if not is_cross and cfg.use_rope:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = attn_ops.mha(q, k, v, causal=causal and not is_cross,
                           window=window, softcap=cfg.attn_softcap, impl=impl)
    elif S == 1:
        # single-token decode: write the new K/V at lengths-1, attend to the
        # cache. The index is mapped as JAX's dynamic_update_slice maps it (a
        # negative start counts from the end, then it is clamped into
        # [0, L-1]), so no write can leave the cache.
        if lengths is None:
            raise ValueError("decode against a cache needs lengths")
        L = cache["k"].shape[1]
        idx = lengths.long() - 1
        idx = torch.where(idx < 0, idx + L, idx).clamp(0, L - 1)
        rows = torch.arange(B, device=x.device)
        cache["k"][rows, idx] = k[:, 0].to(cache["k"].dtype)
        cache["v"][rows, idx] = v[:, 0].to(cache["v"].dtype)
        out = attn_ops.decode_mha(q, cache["k"], cache["v"], lengths,
                                  window=window, softcap=cfg.attn_softcap,
                                  impl=impl)
    else:
        # prefill into an empty cache (S tokens at positions [0, S))
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
        out = attn_ops.mha(q, k, v, causal=True, window=window,
                           softcap=cfg.attn_softcap, impl=impl)
    out = out.reshape(B, S, H * hd)
    return dense(out, p["wo"], compute_dtype), cache


def init_cross_kv_cache(p: Dict[str, Any], enc_out: torch.Tensor,
                        cfg: ModelConfig, compute_dtype=torch.bfloat16
                        ) -> Dict[str, torch.Tensor]:
    """Cross-attention K/V [B, S_enc, KV, hd] from the encoder output, in
    the compute dtype (the decode cache's cross entries)."""
    B, Senc, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": dense(enc_out, p["wk"], compute_dtype).reshape(B, Senc, KV, hd),
            "v": dense(enc_out, p["wv"], compute_dtype).reshape(B, Senc, KV, hd)}
