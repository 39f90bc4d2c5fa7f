"""Dispatching wrapper for the RWKV6 wkv scan (twin of
``repro.kernels.rwkv6_scan.ops``).

Implementations:
- "ref":   the exact per-step recurrence (``ref.py``; oracle);
- "torch": the chunked GLA-style form in plain PyTorch (the reference's
           "xla" path, ``_rwkv6_xla``); the kernel's plain version;
- "cuda":  the hand-written Hopper kernel (``kernel.py``).

``impl=None`` picks "cuda" for CUDA tensors and "torch" for CPU tensors.
A CUDA tensor never falls back: the kernel launches or raises.

Training (grad mode on and an input that needs a gradient) goes through
``Rwkv6ScanFunction`` with "torch" or "cuda": the reference's group
checkpoint written by hand (``kernels/scan_groups.py``). Its forward runs
the chosen impl group by group and keeps each group's entry state; its
backward recomputes each group with the plain chunked form under autograd,
in PyTorch on either device (the reference has no Pallas backward).
"ref" trains by plain autograd.

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

from ..scan_groups import backward_groups, forward_groups
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
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown rwkv6 scan impl: {impl}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (r, k, v, w, u, state)):
        return Rwkv6ScanFunction.apply(r, k, v, w, u, state, impl, chunk)
    if impl == "torch":
        return _rwkv6_torch(r, k, v, w, u, state, chunk=chunk)
    from .kernel import rwkv6_scan as rwkv6_scan_cuda
    return rwkv6_scan_cuda(r, k, v, w, u, state)


class Rwkv6ScanFunction(torch.autograd.Function):
    """The scan's training form. Forward: groups of 16 chunks (halved
    until they divide the chunk count), each through ``impl`` ("cuda": one
    kernel launch a group, its initial state the previous group's final
    state; "torch": ``_rwkv6_chunks``), each group's entry state saved.
    Backward: the groups in reverse, each recomputed by ``_rwkv6_chunks``
    from its entry state under autograd, giving dr, dk, dv, dw (zero where
    the log-decay clamp binds, as in the reference), du summed over batch
    and time, and the initial state's gradient. The kernel takes fp32 u,
    w and state only, and the train step hands over a bf16 u: they are
    cast here, and each gradient comes back in its input's dtype."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state, impl, chunk):
        B, S, H, D = r.shape
        C = min(chunk, S)
        uf = u.float()
        s0 = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
              if state is None else state.float().contiguous())
        if impl == "cuda":
            from .kernel import rwkv6_scan as rwkv6_scan_cuda
            uc = uf.contiguous()

            def run(a, b, s):
                return rwkv6_scan_cuda(
                    *(t[:, a:b].contiguous() for t in (r, k, v)),
                    w[:, a:b].float().contiguous(), uc, s)
        else:
            def run(a, b, s):
                return _rwkv6_chunks(r[:, a:b], k[:, a:b], v[:, a:b],
                                     w[:, a:b], uf, s, C)
        out, s, entries = forward_groups(run, S, C, s0)
        ctx.save_for_backward(r, k, v, w, u, *entries)
        ctx.chunk = C
        ctx.state_dtype = None if state is None else state.dtype
        return out, s

    @staticmethod
    def backward(ctx, dout, dstate):
        r, k, v, w, u, *entries = ctx.saved_tensors
        C = ctx.chunk
        (dr, dk, dv, dw), (du,), ds = backward_groups(
            lambda *a: _rwkv6_chunks(*a, C), (r, k, v, w), (u,), entries, C,
            dout, dstate)
        ds = None if ctx.state_dtype is None else ds.to(ctx.state_dtype)
        return dr, dk, dv, dw, du.to(u.dtype), ds, None, None


def _clamped_log_decay(w: torch.Tensor) -> torch.Tensor:
    logw = torch.log(w.float().clamp(1e-30, 1.0))
    return logw.clamp(-LOG_DECAY_CLAMP, -1e-6)


def _rwkv6_torch(r, k, v, w, u, state, *, chunk: int):
    return _rwkv6_chunks(r, k, v, w, u, state, min(chunk, r.shape[1]))


def _rwkv6_chunks(r, k, v, w, u, state, C: int):
    """The chunked form over chunks of exactly ``C`` steps, the last one
    zero-padded; the training form's backward recomputes a group of chunks
    with it. The terms within each chunk are computed for every chunk at
    once; only the state's carry from chunk to chunk (two products a
    chunk) runs in a loop, and then the state's share of each chunk's
    output, for every chunk at once again."""
    B, S, H, D = r.shape
    n = -(-S // C)
    Sp = n * C

    def pad(t):          # zeros past S: no key adds, log-decay 0 keeps S
        return F.pad(t, (0, 0, 0, 0, 0, Sp - S)) if Sp != S else t

    def chunked(t):      # [n, B, H, C, D]
        return pad(t).reshape(B, n, C, H, D).permute(1, 0, 3, 2, 4)

    rc, kc, vc = (chunked(t.float()) for t in (r, k, v))
    lw = chunked(_clamped_log_decay(w))
    uf = u.float()
    s = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    mask = torch.tril(torch.ones((C, C), dtype=torch.float32,
                                 device=r.device), -1)          # strict lower
    cs = lw.cumsum(dim=3)                        # log A_t within each chunk
    r_t = rc * torch.exp(cs - lw)                # r . A_{t-1}
    k_t = kc * torch.exp(-cs)                    # k / A_t
    att = torch.einsum("nbhcd,nbhjd->nbhcj", r_t, k_t) * mask
    intra = torch.einsum("nbhcj,nbhjd->nbhcd", att, vc)
    diag = torch.einsum("nbhcd,nbhcd->nbhc", rc * uf[None, None, :, None, :],
                        kc)
    k_end = kc * torch.exp(cs[..., -1:, :] - cs)         # A_C / A_j . k_j
    kv_end = torch.einsum("nbhjd,nbhjv->nbhdv", k_end, vc)
    a_end = torch.exp(cs[..., -1, :, None])               # [n, B, H, D, 1]
    starts = []                                  # each chunk's entry state
    for i in range(n):
        starts.append(s)
        s = a_end[i] * s + kv_end[i]
    out = intra + torch.einsum("nbhcd,nbhdv->nbhcv", r_t,
                               torch.stack(starts))
    out = out + diag[..., None] * vc
    out = out.permute(1, 0, 3, 2, 4).reshape(B, Sp, H, D)
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
