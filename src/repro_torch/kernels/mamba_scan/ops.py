"""Dispatching wrapper for the Mamba selective scan (twin of
``repro.kernels.mamba_scan.ops``).

Implementations:
- "ref":   the exact per-step recurrence (``ref.py``; oracle);
- "torch": the chunked cumulative-sum form in plain PyTorch (the
           reference's "xla" path, ``_mamba_xla``); the kernel's plain
           version;
- "cuda":  the hand-written Hopper kernel (``kernel.py``).

``impl=None`` picks "cuda" for CUDA tensors and "torch" for CPU tensors.
A CUDA tensor never falls back: the kernel launches or raises.

Within a chunk of length C, with cs_t = cumsum(clamp(dt*A)) (log decay):

    h_t = exp(cs_t) * (h_0 + sum_{j<=t} exp(-cs_j) * db_j)

The clamp bounds exp(-cs_j) <= exp(C * CLAMP); C = 16 keeps it inside the
fp32 range. Steps with dt <= 0 (the zero padding) neither decay nor add.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .ref import LOG_DECAY_CLAMP, mamba_scan_ref

DEFAULT_CHUNK = 16


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
               state: Optional[torch.Tensor] = None, *,
               chunk: int = DEFAULT_CHUNK, impl: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: [Bt, S, DI]; A: [DI, N]; B, C: [Bt, S, N]; D: [DI]; state
    [Bt, DI, N] fp32 or None. Returns (y in x's dtype, final state)."""
    impl = impl or ("cuda" if x.is_cuda else "torch")
    if impl == "ref":
        return mamba_scan_ref(x, dt, A, B, C, D, state)
    if impl == "torch":
        return _mamba_torch(x, dt, A, B, C, D, state, chunk=chunk)
    if impl == "cuda":
        from .kernel import mamba_scan as mamba_scan_cuda
        return mamba_scan_cuda(x, dt, A, B, C, D, state)
    raise ValueError(f"unknown mamba scan impl: {impl}")


def _mamba_torch(x, dt, A, B, C, D, state, *, chunk: int):
    Bt, S, DI = x.shape
    N = A.shape[-1]
    Cn = min(chunk, S)
    n = -(-S // Cn)
    Sp = n * Cn

    def chunked(t):      # zero-padded (dt = 0 there) to [n, Bt, Cn, *]
        t = t.float()
        t = F.pad(t, (0, 0, 0, Sp - S)) if Sp != S else t
        return t.reshape(Bt, n, Cn, t.shape[-1]).transpose(0, 1)

    xs, dts, Bs, Cs = (chunked(t) for t in (x, dt, B, C))
    Af, Df = A.float(), D.float()
    h = (torch.zeros((Bt, DI, N), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    ys = []
    for i in range(n):
        xc, dtc, bc, cc = xs[i], dts[i], Bs[i], Cs[i]
        lda = dtc[..., None] * Af                           # [Bt,Cn,DI,N]
        lda = torch.where(dtc[..., None] > 0,
                          lda.clamp(-LOG_DECAY_CLAMP, -1e-8),
                          torch.zeros((), device=x.device))
        cs = lda.cumsum(dim=1)
        db = dtc[..., None] * bc[:, :, None, :] * xc[..., None]
        cum = (db * torch.exp(-cs)).cumsum(dim=1)
        hh = torch.exp(cs) * (h[:, None] + cum)             # [Bt,Cn,DI,N]
        ys.append(torch.einsum("bcdn,bcn->bcd", hh, cc) + Df * xc)
        h = hh[:, -1]
    y = torch.stack(ys, dim=1).reshape(Bt, Sp, DI)[:, :S]
    return y.to(x.dtype), h


def mamba_decode_step(x, dt, A, B, C, D, state):
    """Single-token recurrence. x, dt: [Bt, DI]; B, C: [Bt, N]."""
    xf, dtf, bf, cf = (t.float() for t in (x, dt, B, C))
    Af, Df = A.float(), D.float()
    lda = (dtf[..., None] * Af[None]).clamp(-LOG_DECAY_CLAMP, -1e-8)
    h = torch.exp(lda) * state + dtf[..., None] * bf[:, None, :] * xf[..., None]
    y = torch.einsum("bdn,bn->bd", h, cf) + Df * xf
    return y.to(x.dtype), h
