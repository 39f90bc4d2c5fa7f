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
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels.flash_attention import ops as attn_ops
from ..sharding import collectives as col
from ..sharding.api import active_rules, shard
from .config import ModelConfig
from .layers import dense, dense_axes, rope


def attn_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes of an attention block's tree (self or cross)."""
    return {"wq": dense_axes("embed", "heads_flat", cfg.qkv_bias),
            "wk": dense_axes("embed", "kv_flat", cfg.qkv_bias),
            "wv": dense_axes("embed", "kv_flat", cfg.qkv_bias),
            "wo": dense_axes("heads_flat", "embed")}


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
    (out [B, S, D], the cache or None).

    Under sharding rules with DTensor inputs, the attention kernel runs on
    each rank's local heads or local q rows (``_attend``), the decode
    attention on its slice of the sequence-sharded cache
    (``attn_ops.decode_mha``), and the cache writes on each rank's slice
    (``_write_cache``)."""
    if kind not in ("g", "l"):
        raise NotImplementedError(f"attention layer kind {kind!r}")
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    window = cfg.sliding_window if kind == "l" else 0
    # each projection is laid out by its heads before the heads are split
    # off (identity without rules)
    q = shard(dense(x, p["wq"], compute_dtype), "batch", "attn_seq",
              "heads").reshape(B, S, H, hd)
    is_cross = kv_x is not None
    if is_cross and cache is not None:
        # decode-time cross attention: K/V precomputed at prefill
        if cache["k"].shape[1] == 0:
            raise ValueError(
                "cross-attention against a cache with enc_len 0: build the "
                "cache with enc_len > 0, or prefill with frames")
        q = shard(q, "batch", "attn_seq", "heads", None)
        rules = active_rules()
        if (S == 1 and isinstance(cache["k"], DTensor) and rules is not None
                and isinstance(rules.bindings.get("cache_seq"), str)):
            # one query row against a sequence-sharded cross cache: every
            # position is valid, so it is decode attention at length T,
            # which combines each rank's slice (``_decode_mha_seq_sharded``)
            # instead of gathering the cache to every rank, as the
            # reference's partitioner splits it
            T = cache["k"].shape[1]
            out = attn_ops.decode_mha(
                q, cache["k"], cache["v"],
                torch.full((B,), T, dtype=torch.int32, device=x.device),
                softcap=cfg.attn_softcap, impl=impl)
        else:
            out = _attend(q, cache["k"], cache["v"], causal=False,
                          softcap=cfg.attn_softcap, impl=impl)
        out = shard(out, "batch", "attn_seq", "heads", None)
        return _out_proj(out.reshape(B, S, H * hd), p["wo"],
                         compute_dtype), cache
    src = kv_x if is_cross else x
    Skv = src.shape[1]
    k = shard(dense(src, p["wk"], compute_dtype), "batch", "kv_seq",
              "kv_heads").reshape(B, Skv, KV, hd)
    v = shard(dense(src, p["wv"], compute_dtype), "batch", "kv_seq",
              "kv_heads").reshape(B, Skv, KV, hd)
    if not is_cross and cfg.use_rope:
        if positions is None:
            positions = torch.arange(S, device=x.device)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    q = shard(q, "batch", "attn_seq", "heads", None)
    k = shard(k, "batch", "kv_seq", "kv_heads", None)
    v = shard(v, "batch", "kv_seq", "kv_heads", None)
    if cache is None:
        out = _attend(q, k, v, causal=causal and not is_cross,
                      window=window, softcap=cfg.attn_softcap, impl=impl)
    elif S == 1:
        # single-token decode: write the new K/V at lengths-1, attend to the
        # cache. The index is mapped as JAX's dynamic_update_slice maps it (a
        # negative start counts from the end, then it is clamped into
        # [0, L-1]), so no write can leave the cache.
        if lengths is None:
            raise ValueError("decode against a cache needs lengths")
        if isinstance(cache["k"], DTensor):
            _write_cache(cache, k, v, lengths)
        else:
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
        if isinstance(cache["k"], DTensor):
            _write_cache(cache, k, v, None)
        else:
            cache["k"][:, :S] = k.to(cache["k"].dtype)
            cache["v"][:, :S] = v.to(cache["v"].dtype)
        out = _attend(q, k, v, causal=True, window=window,
                      softcap=cfg.attn_softcap, impl=impl)
    out = shard(out, "batch", "attn_seq", "heads", None)
    out = out.reshape(B, S, H * hd)
    return _out_proj(out, p["wo"], compute_dtype), cache


def _out_proj(out, wo, compute_dtype):
    """Attention output projection. tp_heads layout (``heads`` and ``seq``
    bound to one mesh axis): ``out`` is head-sharded and the wo contraction
    is partial across the axis, so the explicit body
    (``repro.models.attention._out_proj``) reduce-scatters it to the
    seq-sharded residual layout, after gathering wo over the FSDP axis."""
    rules = active_rules()
    axis = rules.bindings.get("heads") if rules is not None else None
    seq_ax = rules.bindings.get("seq") if rules is not None else None
    S = out.shape[1]
    if (rules is None or not isinstance(axis, str) or axis != seq_ax
            or S == 1 or "b" in wo):
        return shard(dense(out, wo, compute_dtype), "batch", "seq", "embed")
    mesh = out.device_mesh
    bd = rules.bound("batch")
    fa = rules.axis("embed")

    def body(o_loc, w_loc):
        if fa is not None:
            w_loc = col.gather(w_loc, 1, mesh, fa)
        partial = o_loc.to(compute_dtype) @ w_loc.to(compute_dtype)
        return col.scatter_sum(partial, 1, mesh, axis)

    return col.local_call(
        body, mesh, (out, wo["w"]),
        (col.layout(mesh, {bd: 0, axis: 2}), col.layout(mesh, {axis: 0, fa: 1})),
        col.layout(mesh, {bd: 0, axis: 1}))


def _attend(q, k, v, *, causal: bool, window: int = 0, softcap: float = 0.0,
            impl: Optional[str] = None) -> torch.Tensor:
    """``attn_ops.mha``; for DTensors, on this rank's local q (its heads,
    or its rows with their global offset as ``q_offset``) against the K/V
    that those rows need: K/V are gathered over every mesh dim that does
    not shard them as q's batch or heads, and where q's heads are sharded
    and K/V's are not, the kv heads of the local q heads are sliced out."""
    kw = dict(causal=causal, window=window, softcap=softcap, impl=impl)
    if not isinstance(q, DTensor):
        return attn_ops.mha(q, k, v, **kw)
    mesh = q.device_mesh
    G = q.shape[2] // k.shape[2]
    kv_pl = tuple(p if isinstance(p, Shard) and p.dim == 0 else
                  (p if p == Shard(2) and kp == Shard(2) else Replicate())
                  for p, kp in zip(q.placements, k.placements))
    q_off = col.global_offset(q)
    Hl = col.local_shape(q)[2]
    kv_heads_local = any(p == Shard(2) for p in kv_pl)
    if not kv_heads_local and Hl < q.shape[2] and Hl % G and G % Hl:
        raise ValueError(f"{Hl} local q heads do not align with groups of {G}")

    def body(ql, kl, vl):
        if not kv_heads_local and Hl < q.shape[2]:
            lo, hi = q_off[2] // G, (q_off[2] + Hl - 1) // G + 1
            kl, vl = kl[:, :, lo:hi].contiguous(), vl[:, :, lo:hi].contiguous()
        return attn_ops.mha(ql.contiguous(), kl.contiguous(), vl.contiguous(),
                            q_offset=q_off[1], **kw)

    return col.local_call(body, mesh, (q, k, v),
                          (q.placements, kv_pl, kv_pl), q.placements)


@torch.no_grad()
def _write_cache(cache: Dict[str, DTensor], k, v, lengths) -> None:
    """Write K/V into a cache whose sequence dim may be sharded: at
    prefill (``lengths`` None) the S new rows at positions [0, S), at
    decode the one new row at ``lengths - 1`` (mapped as the unsharded
    write maps it). Each rank writes the rows that fall in its slice of
    the sequence; K/V are gathered over the other mesh dims."""
    c = cache["k"]
    mesh = c.device_mesh
    L = c.shape[1]
    pl = tuple(p if p == Shard(0) else Replicate() for p in c.placements)
    off = col.global_offset(c)[1]
    L_loc = col.local_shape(c)[1]
    for name, new in (("k", k), ("v", v)):
        dst = cache[name].to_local()
        src = col.local_part(new, mesh, pl)
        if lengths is None:
            n = max(0, min(src.shape[1] - off, L_loc))
            dst[:, :n] = src[:, off:off + n].to(dst.dtype)
            continue
        lens = col.local_part(lengths, mesh, pl)
        idx = lens.long() - 1
        idx = torch.where(idx < 0, idx + L, idx).clamp(0, L - 1) - off
        own = (idx >= 0) & (idx < L_loc)
        idx = idx.clamp(0, L_loc - 1)
        rows = torch.arange(dst.shape[0], device=dst.device)
        row = torch.where(own[:, None, None], src[:, 0].to(dst.dtype),
                          dst[rows, idx])
        dst[rows, idx] = row
def init_cross_kv_cache(p: Dict[str, Any], enc_out: torch.Tensor,
                        cfg: ModelConfig, compute_dtype=torch.bfloat16
                        ) -> Dict[str, torch.Tensor]:
    """Cross-attention K/V [B, S_enc, KV, hd] from the encoder output, in
    the compute dtype (the decode cache's cross entries)."""
    B, Senc, _ = enc_out.shape
    KV, hd = cfg.n_kv_heads, cfg.head_dim
    return {"k": dense(enc_out, p["wk"], compute_dtype).reshape(B, Senc, KV, hd),
            "v": dense(enc_out, p["wv"], compute_dtype).reshape(B, Senc, KV, hd)}
