"""Dispatching wrapper for attention (twin of
``repro.kernels.flash_attention.ops``).

Implementations:
- "ref":   naive materialized softmax (oracle; small shapes only);
- "torch": chunked online-softmax attention in plain PyTorch, forward only
           (the reference's "xla" path, ``_mha_fwd_impl``); the kernel's
           plain version;
- "cuda":  the hand-written Hopper kernel (``kernel.py``).

``impl=None`` picks "cuda" for CUDA tensors and "torch" for CPU tensors.
A CUDA tensor never falls back: the kernel launches or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ref import mha_ref

_NEG_INF = -1e30


def _auto_impl(t: torch.Tensor) -> str:
    return "cuda" if t.is_cuda else "torch"


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int = 0, softcap: float = 0.0,
        scale: Optional[float] = None, q_offset: int = 0,
        q_chunk: int = 1024, kv_chunk: int = 1024,
        impl: Optional[str] = None) -> torch.Tensor:
    """Multi-head (GQA) attention. q [B,S,H,D]; k,v [B,T,KV,D] -> [B,S,H,D]."""
    impl = impl or _auto_impl(q)
    if impl == "ref":
        return mha_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                       scale=scale, q_offset=q_offset)
    if impl == "torch":
        return _mha_torch(q, k, v, causal=causal, window=window,
                          softcap=softcap, scale=scale, q_offset=q_offset,
                          q_chunk=q_chunk, kv_chunk=kv_chunk)
    if impl == "cuda":
        from .kernel import flash_attention
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale,
                               q_offset=q_offset)
    raise ValueError(f"unknown attention impl: {impl}")


def _mha_torch(q, k, v, *, causal, window, softcap, scale, q_offset,
               q_chunk, kv_chunk):
    """Online softmax over (q-chunk, kv-chunk) tiles: streams stay in the
    input dtype, scores, softmax statistics and accumulation are fp32, and
    p is cast to v's dtype before the PV product (the kernel's contract).
    A ragged last chunk is sliced rather than padded: padded keys are
    masked to exactly zero in the reference, so the result is the same."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    out = torch.empty_like(q)
    for q0 in range(0, S, q_chunk):
        qi = q[:, q0:q0 + q_chunk]
        n = qi.shape[1]
        qi = qi.reshape(B, n, KV, G, D).float()
        qpos = torch.arange(q0, q0 + n, device=dev) + q_offset
        acc = torch.zeros((B, n, KV, G, D), dtype=torch.float32, device=dev)
        m = torch.full((B, n, KV, G), _NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, n, KV, G), dtype=torch.float32, device=dev)
        for k0 in range(0, T, kv_chunk):
            ki, vi = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            kpos = torch.arange(k0, k0 + ki.shape[1], device=dev)
            s = torch.einsum("bsngd,btnd->bsngt", qi, ki.float()) * scale
            if softcap > 0.0:
                s = torch.tanh(s / softcap) * softcap
            mask = torch.ones((n, ki.shape[1]), dtype=torch.bool, device=dev)
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window > 0:
                mask &= kpos[None, :] > qpos[:, None] - window
            mask = mask[None, :, None, None, :]
            s = s.masked_fill(~mask, _NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # mask p explicitly: a fully-masked tile would otherwise give
            # exp(-inf - -inf) = 1 and corrupt l
            p = torch.exp(s - m_new[..., None]) * mask
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bsngt,btnd->bsngd", p.to(vi.dtype).float(), vi.float())
            m = m_new
        out[:, q0:q0 + n] = (acc / (l[..., None] + 1e-30)).reshape(
            B, n, H, D).to(q.dtype)
    return out


def decode_mha(q: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, lengths: torch.Tensor, *,
               window: int = 0, softcap: float = 0.0,
               scale: Optional[float] = None, kv_chunk: int = 2048,
               impl: Optional[str] = None) -> torch.Tensor:
    """Single-token decode attention over a KV cache.

    q: [B, 1, H, D]; caches: [B, L, KV, D]; lengths: [B] (#valid entries,
    i.e. the new token's position + 1). Returns [B, 1, H, D].
    """
    impl = impl or _auto_impl(q)
    if impl == "ref":
        return decode_mha_ref(q, k_cache, v_cache, lengths, window=window,
                              softcap=softcap, scale=scale)
    if impl == "cuda":
        from ..flash_decode.kernel import flash_decode
        return flash_decode(q, k_cache, v_cache, lengths, window=window,
                            softcap=softcap, scale=scale)
    if impl != "torch":
        raise ValueError(f"unknown decode attention impl: {impl}")
    B, _, H, D = q.shape
    acc, m, l = _decode_partials(q, k_cache, v_cache, lengths, window=window,
                                 softcap=softcap, scale=scale,
                                 kv_chunk=kv_chunk)
    out = acc / (l[..., None] + 1e-30)
    return out.reshape(B, 1, H, D).to(q.dtype)


def _decode_partials(q, k_cache, v_cache, lengths, *, window, softcap,
                     scale, kv_chunk):
    """Online-softmax partials over the cache, the decode kernel's plain
    version. Returns (acc [B,KV,G,D], m [B,KV,G], l [B,KV,G]),
    unnormalized."""
    B, _, H, D = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    qf = q.reshape(B, KV, G, D).float()
    lens = lengths.to(device=dev, dtype=torch.int64)[:, None]
    acc = torch.zeros((B, KV, G, D), dtype=torch.float32, device=dev)
    m = torch.full((B, KV, G), _NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, KV, G), dtype=torch.float32, device=dev)
    for k0 in range(0, L, kv_chunk):
        ki, vi = k_cache[:, k0:k0 + kv_chunk], v_cache[:, k0:k0 + kv_chunk]
        kpos = torch.arange(k0, k0 + ki.shape[1], device=dev)[None, :]
        s = torch.einsum("bngd,btnd->bngt", qf, ki.float()) * scale
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        mask = kpos < lens                                   # [B, ckv]
        if window > 0:
            mask &= kpos > lens - 1 - window
        mask = mask[:, None, None, :]
        s = s.masked_fill(~mask, _NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None]) * mask
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bngt,btnd->bngd", p.to(vi.dtype).float(), vi.float())
        m = m_new
    return acc, m, l


def decode_mha_ref(q, k_cache, v_cache, lengths, *, window: int = 0,
                   softcap: float = 0.0, scale: Optional[float] = None):
    """Oracle for decode attention via the naive path (reads each row's
    length on the host)."""
    outs = []
    for b, t in enumerate(lengths.tolist()):
        outs.append(mha_ref(q[b:b + 1], k_cache[b:b + 1, :t],
                            v_cache[b:b + 1, :t], causal=True, window=window,
                            softcap=softcap, scale=scale, q_offset=t - 1))
    return torch.cat(outs, dim=0)
