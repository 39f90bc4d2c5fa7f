"""Dispatching wrapper for the RWKV6 wkv scan (twin of
``repro.kernels.rwkv6_scan.ops``).

Implementations:
- "ref":   the exact per-step recurrence (``ref.py``; oracle);
- "torch": the chunked GLA-style form in plain PyTorch (the reference's
           "xla" path, ``_rwkv6_xla``); the kernel's plain version;
- "cuda":  the hand-written Hopper kernel (``kernel.py``).

``impl=None`` picks "cuda" for CUDA tensors and "torch" for CPU tensors.
A CUDA tensor never falls back: the kernel launches or raises.

Within a chunk of length C (default 16), with A_t = prod_{s<=t} w_s:

    out_t = (r_t . A_{t-1}) S_0
          + sum_{j<t} [(r_t . A_{t-1}) . (k_j / A_j)] v_j      (strict lower)
          + (r_t . u . k_t) v_t                                 (diagonal)
    S_C   = diag(A_C) S_0 + sum_j (A_C / A_j . k_j) v_j^T

The log-decay is clamped to [-LOG_DECAY_CLAMP, -1e-6]; with C = 16,
|cumsum| <= 16 * LOG_DECAY_CLAMP stays inside the fp32 exp range.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .ref import rwkv6_scan_ref

LOG_DECAY_CLAMP = 5.0
DEFAULT_CHUNK = 16


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None, *,
               chunk: int = DEFAULT_CHUNK, impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,w: [B, S, H, D]; u: [H, D]; state [B, H, D, D] fp32 or None.
    Returns (out [B, S, H, D] in r's dtype, final state fp32)."""
    impl = impl or ("cuda" if r.is_cuda else "torch")
    if impl == "ref":
        return rwkv6_scan_ref(r, k, v, w, u, state)
    if impl == "torch":
        return _rwkv6_torch(r, k, v, w, u, state, chunk=chunk)
    if impl == "cuda":
        from .kernel import rwkv6_scan as rwkv6_scan_cuda
        return rwkv6_scan_cuda(r, k, v, w, u, state)
    raise ValueError(f"unknown rwkv6 scan impl: {impl}")


def _clamped_log_decay(w: torch.Tensor) -> torch.Tensor:
    logw = torch.log(w.float().clamp(1e-30, 1.0))
    return logw.clamp(-LOG_DECAY_CLAMP, -1e-6)


def _rwkv6_torch(r, k, v, w, u, state, *, chunk: int):
    B, S, H, D = r.shape
    C = min(chunk, S)
    n = -(-S // C)
    Sp = n * C

    def pad(t):          # zeros past S: no key adds, log-decay 0 keeps S
        return F.pad(t, (0, 0, 0, 0, 0, Sp - S)) if Sp != S else t

    def chunked(t):      # [n, B, H, C, D]
        return pad(t).reshape(B, n, C, H, D).permute(1, 0, 3, 2, 4)

    rc, kc, vc = (chunked(t.float()) for t in (r, k, v))
    lwc = chunked(_clamped_log_decay(w))
    uf = u.float()
    s = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    mask = torch.tril(torch.ones((C, C), dtype=torch.float32,
                                 device=r.device), -1)          # strict lower
    outs = []
    for i in range(n):
        rch, kch, vch, lw = rc[i], kc[i], vc[i], lwc[i]      # [B, H, C, D]
        cs = lw.cumsum(dim=2)                    # log A_t
        r_t = rch * torch.exp(cs - lw)           # r . A_{t-1}
        k_t = kch * torch.exp(-cs)               # k / A_t
        att = torch.einsum("bhcd,bhjd->bhcj", r_t, k_t) * mask
        out = torch.einsum("bhcj,bhjd->bhcd", att, vch)
        out = out + torch.einsum("bhcd,bhdv->bhcv", r_t, s)
        diag = torch.einsum("bhcd,bhcd->bhc", rch * uf[None, :, None, :], kch)
        out = out + diag[..., None] * vch
        k_end = kch * torch.exp(cs[:, :, -1:, :] - cs)   # A_C / A_j . k_j
        s = torch.exp(cs[:, :, -1, :, None]) * s + torch.einsum(
            "bhjd,bhjv->bhdv", k_end, vch)
        outs.append(out)
    out = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, Sp, H, D)
    return out[:, :S].to(r.dtype), s


def rwkv6_decode_step(r, k, v, w, u, state):
    """Single-token recurrence. r,k,v,w: [B, H, D]; state [B, H, D, D]."""
    rf, kf, vf = (t.float() for t in (r, k, v))
    wf = torch.exp(_clamped_log_decay(w))
    uf = u.float()
    kv = kf[..., :, None] * vf[..., None, :]
    out = torch.einsum("bhk,bhkv->bhv", rf, state + uf[..., :, None] * kv)
    state = wf[..., :, None] * state + kv
    return out.to(r.dtype), state
