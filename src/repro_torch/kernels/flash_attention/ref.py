"""Naive materialized-softmax oracle for flash attention (twin of
``repro.kernels.flash_attention.ref.mha_ref``). Supports GQA, causal
masking, sliding windows and logit soft-capping. Small shapes only."""
from __future__ import annotations

from typing import Optional

import torch


def mha_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool = True, window: int = 0, softcap: float = 0.0,
            scale: Optional[float] = None,
            q_offset: int = 0) -> torch.Tensor:
    """q: [B, S, H, D]; k, v: [B, T, KV, D] with H % KV == 0.
    ``q_offset``: global position of q[0] (for decode: T - S).
    Returns [B, S, H, D] in q.dtype."""
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qf = q.float().reshape(B, S, KV, G, D)
    scores = torch.einsum("bsngd,btnd->bnsgt", qf, k.float()) * scale
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    qpos = torch.arange(S, device=q.device) + q_offset
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= kpos[None, :] > qpos[:, None] - window
    scores = scores.masked_fill(~mask[None, None, :, None, :], -1e30)
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    p = p / (p.sum(dim=-1, keepdim=True) + 1e-30)
    out = torch.einsum("bnsgt,btnd->bsngd", p, v.float())
    return out.reshape(B, S, H, D).to(q.dtype)
