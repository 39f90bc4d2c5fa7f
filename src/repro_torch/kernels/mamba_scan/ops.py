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

Training (grad mode on and an input that needs a gradient) goes through
``MambaScanFunction`` with "torch" or "cuda", built as the RWKV6 scan's
(``kernels/scan_groups.py``): the chosen impl's forward group by group,
the backward a plain recompute of each group under autograd. "ref" trains
by plain autograd.

Within a chunk of length C, with cs_t = cumsum(clamp(dt*A)) (log decay):

    h_t = exp(cs_t) * (h_0 + sum_{j<=t} exp(-cs_j) * db_j)

The clamp bounds exp(-cs_j) <= exp(C * CLAMP); C = 16 keeps it inside the
fp32 range. Steps with dt <= 0 (the zero padding) neither decay nor add.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..scan_groups import backward_groups, forward_groups
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
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown mamba scan impl: {impl}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, D, state)):
        return MambaScanFunction.apply(x, dt, A, B, C, D, state, impl, chunk)
    if impl == "torch":
        return _mamba_torch(x, dt, A, B, C, D, state, chunk=chunk)
    from .kernel import mamba_scan as mamba_scan_cuda
    return mamba_scan_cuda(x, dt, A, B, C, D, state)


class MambaScanFunction(torch.autograd.Function):
    """The scan's training form, as ``Rwkv6ScanFunction``: the forward
    through ``impl`` a group of chunks at a time ("cuda": one kernel
    launch a group), each group's entry state saved; the backward
    recomputes each group by ``_mamba_chunks`` under autograd, in
    reverse. dA and dD are summed over batch and time; padded steps
    (dt = 0) neither decay nor add and take no gradient. The kernel takes
    fp32 only, and the train step hands over a bf16 A and D: everything
    is cast here, and each gradient comes back in its input's dtype."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, D, state, impl, chunk):
        Bt, S, DI = x.shape
        Cn = min(chunk, S)
        Af, Df = A.float().contiguous(), D.float().contiguous()
        h0 = (torch.zeros((Bt, DI, A.shape[-1]), dtype=torch.float32,
                          device=x.device)
              if state is None else state.float().contiguous())
        if impl == "cuda":
            from .kernel import mamba_scan as mamba_scan_cuda

            def run(a, b, h):
                xs, dts, bs, cs = (t[:, a:b].float().contiguous()
                                   for t in (x, dt, B, C))
                y, h = mamba_scan_cuda(xs, dts, Af, bs, cs, Df, h)
                return y.to(x.dtype), h
        else:
            def run(a, b, h):
                return _mamba_chunks(x[:, a:b], dt[:, a:b], Af, B[:, a:b],
                                     C[:, a:b], Df, h, Cn)
        y, h, entries = forward_groups(run, S, Cn, h0)
        ctx.save_for_backward(x, dt, B, C, A, D, *entries)
        ctx.chunk = Cn
        ctx.state_dtype = None if state is None else state.dtype
        return y, h

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, B, C, A, D, *entries = ctx.saved_tensors
        Cn = ctx.chunk

        def body(x, dt, B, C, A, D, h):
            return _mamba_chunks(x, dt, A, B, C, D, h, Cn)
        (dx, ddt, dB, dC), (dA, dD), ds = backward_groups(
            body, (x, dt, B, C), (A, D), entries, Cn, dy, dstate)
        ds = None if ctx.state_dtype is None else ds.to(ctx.state_dtype)
        return (dx, ddt, dA.to(A.dtype), dB, dC, dD.to(D.dtype), ds, None,
                None)


def _mamba_torch(x, dt, A, B, C, D, state, *, chunk: int):
    return _mamba_chunks(x, dt, A, B, C, D, state, min(chunk, x.shape[1]))


def _mamba_chunks(x, dt, A, B, C, D, state, Cn: int):
    """The chunked form over chunks of exactly ``Cn`` steps, the last one
    zero-padded (dt = 0 there); the training form's backward recomputes a
    group of chunks with it. The terms within each chunk are computed for
    every chunk at once; only the state's carry from chunk to chunk runs
    in a loop, and then each step's state and output, for every chunk at
    once again."""
    Bt, S, DI = x.shape
    N = A.shape[-1]
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
    lda = dts[..., None] * Af                          # [n,Bt,Cn,DI,N]
    lda = torch.where(dts[..., None] > 0,
                      lda.clamp(-LOG_DECAY_CLAMP, -1e-8),
                      torch.zeros((), device=x.device))
    cs = lda.cumsum(dim=2)
    db = dts[..., None] * Bs[:, :, :, None, :] * xs[..., None]
    cum = (db * torch.exp(-cs)).cumsum(dim=2)
    a_end, cum_end = torch.exp(cs[:, :, -1]), cum[:, :, -1]   # [n,Bt,DI,N]
    starts = []                                  # each chunk's entry state
    for i in range(n):
        starts.append(h)
        h = a_end[i] * (h + cum_end[i])
    hh = torch.exp(cs) * (torch.stack(starts)[:, :, None] + cum)
    y = torch.einsum("nbcdk,nbck->nbcd", hh, Cs) + Df * xs
    y = y.transpose(0, 1).reshape(Bt, Sp, DI)[:, :S]
    return y.to(x.dtype), h


def mamba_decode_step(x, dt, A, B, C, D, state):
    """Single-token recurrence. x, dt: [Bt, DI]; B, C: [Bt, N]."""
    xf, dtf, bf, cf = (t.float() for t in (x, dt, B, C))
    Af, Df = A.float(), D.float()
    lda = (dtf[..., None] * Af[None]).clamp(-LOG_DECAY_CLAMP, -1e-8)
    h = torch.exp(lda) * state + dtf[..., None] * bf[:, None, :] * xf[..., None]
    y = torch.einsum("bdn,bn->bd", h, cf) + Df * xf
    return y.to(x.dtype), h
