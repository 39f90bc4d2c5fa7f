"""Dispatching wrapper for attention (twin of
``repro.kernels.flash_attention.ops``).

Implementations:
- "ref":   naive materialized softmax (oracle; small shapes only), trained
           through by plain autograd;
- "torch": chunked online-softmax attention in plain PyTorch (the
           reference's "xla" path, ``_mha_fwd_impl``); the kernel's plain
           version;
- "cuda":  the hand-written Hopper kernel (``kernel.py``).

``impl=None`` picks "cuda" for CUDA tensors and "torch" for CPU tensors.
A CUDA tensor never falls back: the kernel launches or raises.

Training (grad mode on and an input that needs a gradient) goes through
``MhaFunction``, the port of the reference's custom VJP
(``repro.kernels.flash_attention.ops._mha_xla_vjp``): the forward is the
chosen impl's and also gives each row's log-sum-exp; it saves only (q, k,
v, out, lse), and the backward, the port of ``_mha_bwd_impl`` (XLA code in
the reference, not Pallas), recomputes p tile by tile: "cuda" launches the
hand-written backward (``kernel.flash_attention_bwd``), "torch" runs
``_mha_bwd_torch``, the CPU route and the oracle the kernel is held to.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

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
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown attention impl: {impl}")
    kw = dict(causal=causal, window=window, softcap=softcap, scale=scale,
              q_offset=q_offset, q_chunk=q_chunk, kv_chunk=kv_chunk)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return MhaFunction.apply(q, k, v, impl, kw)
    return _mha_fwd(q, k, v, impl, kw, want_lse=False)[0]


def _mha_fwd(q, k, v, impl, kw, *, want_lse):
    """(out, lse [B, S, KV, G] fp32) of ``impl``; the kernel writes its lse
    only when ``want_lse`` (else None)."""
    if impl == "torch":
        return _mha_torch(q, k, v, **kw)
    from .kernel import flash_attention
    kkw = {n: kw[n] for n in ("causal", "window", "softcap", "scale",
                              "q_offset")}
    if not want_lse:
        return flash_attention(q, k, v, **kkw), None
    out, lse = flash_attention(q, k, v, return_lse=True, **kkw)
    B, S, H, _ = q.shape       # the kernel's [B, S, H] is [B, S, KV, G]
    return out, lse.view(B, S, k.shape[2], H // k.shape[2])


def _tile_mask(qpos, kpos, causal, window):
    """[n, m] bool: key position kpos[j] is visible to query qpos[i]."""
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def _tile_live(q0, n, k0, m, *, causal, window, q_offset):
    """Whether any query of rows [q0, q0 + n) sees any key of [k0, k0 + m).
    A tile that sees none adds exactly zero in both passes (its p is
    masked to 0), so skipping it leaves every result as it was."""
    if causal and k0 > q_offset + q0 + n - 1:
        return False
    if window > 0 and k0 + m - 1 <= q_offset + q0 - window:
        return False
    return True


def _mha_torch(q, k, v, *, causal, window, softcap, scale, q_offset,
               q_chunk, kv_chunk):
    """Online softmax over (q-chunk, kv-chunk) tiles: streams stay in the
    input dtype, scores, softmax statistics and accumulation are fp32, and
    p is cast to v's dtype before the PV product (the kernel's contract).
    A ragged last chunk is sliced rather than padded: padded keys are
    masked to exactly zero in the reference, so the result is the same.
    Returns (out [B, S, H, D] in q's dtype, lse [B, S, KV, G] fp32), lse =
    m + log(max(l, 1e-30)) as in ``_mha_fwd_impl``."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    dev = q.device
    out = torch.empty_like(q)
    lse = torch.empty((B, S, KV, G), dtype=torch.float32, device=dev)
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
            if not _tile_live(q0, n, k0, ki.shape[1], causal=causal,
                              window=window, q_offset=q_offset):
                continue
            kpos = torch.arange(k0, k0 + ki.shape[1], device=dev)
            s = torch.einsum("bsngd,btnd->bsngt", qi, ki.float()) * scale
            if softcap > 0.0:
                s = torch.tanh(s / softcap) * softcap
            mask = _tile_mask(qpos, kpos, causal, window)[None, :, None,
                                                          None, :]
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
        lse[:, q0:q0 + n] = m + torch.log(torch.clamp(l, min=1e-30))
    return out, lse


def _mha_bwd_torch(q, k, v, out, lse, dout, *, causal, window, softcap,
                   scale, q_offset, q_chunk, kv_chunk):
    """Flash-style backward (``_mha_bwd_impl``): p is recomputed per (q
    chunk, kv chunk) tile from (q, k, lse), with the softcap's 1 - tanh^2
    factor on ds. Two passes as in the reference: dq over kv chunks, then
    dk and dv over q chunks, each carrying one chunk of its gradient.
    Products take ds and p cast to the input dtype, as the reference casts
    them, and accumulate in fp32. lse: [B, S, KV, G] fp32. Tiles that see
    no key are skipped (they add exactly zero); a ragged last chunk is
    sliced. Returns (dq, dk, dv) in the inputs' dtypes."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    sc = scale if scale is not None else D ** -0.5
    dev = q.device
    f32 = torch.float32
    # Delta_i = rowsum(dout_i * out_i), fp32
    delta = (dout.float() * out.float()).reshape(B, S, KV, G, D).sum(-1)
    qg = q.reshape(B, S, KV, G, D)
    dog = dout.reshape(B, S, KV, G, D)

    def tile(q0, n, k0, m):
        """(p, ds) of one tile, fp32 [B, n, KV, G, m]."""
        qi = qg[:, q0:q0 + n].float()
        doi = dog[:, q0:q0 + n].float()
        ki = k[:, k0:k0 + m].float()
        vi = v[:, k0:k0 + m].float()
        s = torch.einsum("bsngd,btnd->bsngt", qi, ki) * sc
        if softcap > 0.0:
            tanh_t = torch.tanh(s / softcap)
            s = tanh_t * softcap
        qpos = torch.arange(q0, q0 + n, device=dev) + q_offset
        kpos = torch.arange(k0, k0 + m, device=dev)
        mask = _tile_mask(qpos, kpos, causal, window)[None, :, None, None, :]
        p = torch.exp(s - lse[:, q0:q0 + n, ..., None]) * mask
        dp = torch.einsum("bsngd,btnd->bsngt", doi, vi)
        ds = p * (dp - delta[:, q0:q0 + n, ..., None])
        if softcap > 0.0:
            ds = ds * (1.0 - tanh_t * tanh_t)
        return p, ds

    def live(q0, n, k0, m):
        return _tile_live(q0, n, k0, m, causal=causal, window=window,
                          q_offset=q_offset)

    dq = torch.empty_like(q)
    for q0 in range(0, S, q_chunk):                  # pass 1: dq
        n = min(q_chunk, S - q0)
        dq_i = torch.zeros((B, n, KV, G, D), dtype=f32, device=dev)
        for k0 in range(0, T, kv_chunk):
            m = min(kv_chunk, T - k0)
            if not live(q0, n, k0, m):
                continue
            _, ds = tile(q0, n, k0, m)
            dq_i += torch.einsum("bsngt,btnd->bsngd", ds.to(k.dtype).float(),
                                 k[:, k0:k0 + m].float()) * sc
        dq[:, q0:q0 + n] = dq_i.reshape(B, n, H, D).to(q.dtype)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, T, kv_chunk):                 # pass 2: dk, dv
        m = min(kv_chunk, T - k0)
        dk_j = torch.zeros((B, m, KV, D), dtype=f32, device=dev)
        dv_j = torch.zeros((B, m, KV, D), dtype=f32, device=dev)
        for q0 in range(0, S, q_chunk):
            n = min(q_chunk, S - q0)
            if not live(q0, n, k0, m):
                continue
            p, ds = tile(q0, n, k0, m)
            dk_j += torch.einsum("bsngt,bsngd->btnd", ds.to(q.dtype).float(),
                                 qg[:, q0:q0 + n].float()) * sc
            dv_j += torch.einsum("bsngt,bsngd->btnd",
                                 p.to(dout.dtype).float(),
                                 dog[:, q0:q0 + n].float())
        dk[:, k0:k0 + m] = dk_j.to(k.dtype)
        dv[:, k0:k0 + m] = dv_j.to(v.dtype)
    return dq, dk, dv


class MhaFunction(torch.autograd.Function):
    """Attention with the reference's flash-style VJP: the forward is
    ``impl``'s ("cuda": the kernel, which also writes the lse; "torch":
    ``_mha_torch``) and saves (q, k, v, out, lse); the backward is
    ``impl``'s too ("cuda": ``kernel.flash_attention_bwd``, with ``dout``
    made contiguous, as autograd may hand it in any layout; "torch":
    ``_mha_bwd_torch``). ``kw`` holds the keyword arguments of ``mha``
    other than ``impl``."""

    @staticmethod
    def forward(ctx, q, k, v, impl, kw):
        out, lse = _mha_fwd(q, k, v, impl, kw, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.impl, ctx.kw = impl, kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if ctx.impl == "cuda":
            from .kernel import flash_attention_bwd
            dq, dk, dv = flash_attention_bwd(
                q, k, v, out, lse, dout.contiguous(),
                **{n: ctx.kw[n] for n in ("causal", "window", "softcap",
                                          "scale", "q_offset")})
        else:
            dq, dk, dv = _mha_bwd_torch(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None


def decode_mha(q: torch.Tensor, k_cache: torch.Tensor,
               v_cache: torch.Tensor, lengths: torch.Tensor, *,
               window: int = 0, softcap: float = 0.0,
               scale: Optional[float] = None, kv_chunk: int = 2048,
               impl: Optional[str] = None) -> torch.Tensor:
    """Single-token decode attention over a KV cache.

    q: [B, 1, H, D]; caches: [B, L, KV, D]; lengths: [B] (#valid entries,
    i.e. the new token's position + 1). Returns [B, 1, H, D].

    When sharding rules bind "cache_seq" to a mesh axis and the cache is a
    DTensor, the cache is sequence-sharded and the attention runs as a
    flash-decode across ranks (``_decode_mha_seq_sharded``).
    """
    from ...sharding.api import active_rules
    rules = active_rules()
    seq_axis = rules.bindings.get("cache_seq") if rules is not None else None
    if isinstance(seq_axis, str) and isinstance(k_cache, DTensor):
        return _decode_mha_seq_sharded(
            q, k_cache, v_cache, lengths, rules=rules, seq_axis=seq_axis,
            window=window, softcap=softcap, scale=scale, kv_chunk=kv_chunk,
            impl=impl)
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
                     scale, kv_chunk, pos_offset: int = 0):
    """Online-softmax partials over (a slice of) the cache, the decode
    kernel's plain version. ``pos_offset``: global position of
    k_cache[:, 0]; masks and the window use global positions. Returns
    (acc [B,KV,G,D], m [B,KV,G], l [B,KV,G]), unnormalized; a slice with
    no valid row gives acc 0, m -1e30, l 0."""
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
        kpos = torch.arange(k0, k0 + ki.shape[1], device=dev)[None, :] \
            + pos_offset
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


def _decode_mha_seq_sharded(q, k_cache, v_cache, lengths, *, rules,
                            seq_axis, window, softcap, scale, kv_chunk,
                            impl):
    """Flash-decode over a cache sequence-sharded on ``seq_axis``
    (``repro.kernels.flash_attention.ops._decode_mha_seq_sharded``): each
    rank computes the unnormalised partials of its slice at its global
    offset (the decode kernel's partials entry on the card, never
    ``_decode_partials``; the plain version on the CPU), and the partials
    combine with a max-rescaled sum over the axis. A rank whose slice
    holds no valid row adds weight 0. q and lengths are laid out by the
    batch binding only, the caches by batch and ``seq_axis``."""
    from ...sharding import collectives as col
    mesh = k_cache.device_mesh
    B, _, H, D = q.shape
    b = rules.bound("batch")
    rows = col.layout(mesh, {b: 0})
    cache_pl = col.layout(mesh, {b: 0, seq_axis: 1})
    off = col.global_offset(k_cache, cache_pl)[1]

    def body(qi, kc, vc, lens):
        qi, kc, vc = qi.contiguous(), kc.contiguous(), vc.contiguous()
        if (impl or _auto_impl(qi)) == "cuda":
            from ..flash_decode.kernel import flash_decode_partials
            acc, m, l = flash_decode_partials(
                qi, kc, vc, lens, pos_offset=off, window=window,
                softcap=softcap, scale=scale)
        else:
            acc, m, l = _decode_partials(
                qi, kc, vc, lens, window=window, softcap=softcap,
                scale=scale, kv_chunk=kv_chunk, pos_offset=off)
        m_g = col.all_reduce(m, "max", mesh, seq_axis)
        corr = torch.exp(m - m_g)
        l_g = col.all_reduce(l * corr, "sum", mesh, seq_axis)
        acc_g = col.all_reduce(acc * corr[..., None], "sum", mesh, seq_axis)
        out = acc_g / (l_g[..., None] + 1e-30)
        return out.reshape(qi.shape[0], 1, H, D).to(qi.dtype)

    return col.local_call(body, mesh, (q, k_cache, v_cache, lengths),
                          (rows, cache_pl, cache_pl, rows), rows)


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
