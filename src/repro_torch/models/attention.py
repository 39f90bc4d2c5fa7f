"""GQA self-attention block (twin of ``repro.models.attention`` for layer
kinds "g" and "l"): QKV bias, GQA, RoPE, sliding window on "l" layers,
logit softcap, and single-token decode against a KV cache.

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
               cache: Optional[Dict[str, torch.Tensor]] = None,
               lengths: Optional[torch.Tensor] = None,
               impl: Optional[str] = None,
               compute_dtype=torch.bfloat16
               ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x: [B, S, D]. cache: {"k","v"} [B, L, KV, hd] with ``lengths`` [B] =
    #valid tokens incl. the current one (decode). Returns (out [B, S, D],
    the cache or None)."""
    if kind not in ("g", "l"):
        raise NotImplementedError(f"attention layer kind {kind!r}")
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.sliding_window if kind == "l" else 0
    q = dense(x, p["wq"], compute_dtype).reshape(B, S, H, hd)
    k = dense(x, p["wk"], compute_dtype).reshape(B, S, KV, hd)
    v = dense(x, p["wv"], compute_dtype).reshape(B, S, KV, hd)
    if cfg.use_rope:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    if cache is None:
        out = attn_ops.mha(q, k, v, causal=True, window=window,
                           softcap=cfg.attn_softcap, impl=impl)
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
