"""Plain PyTorch oracle for the RWKV6 (Finch) wkv scan: the exact per-step
recurrence (twin of ``repro.kernels.rwkv6_scan.ref``).

State S [B, H, dk, dv]; per step t:
    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T
with data-dependent per-channel decay w_t in (0, 1), used as given (no
clamp, as in the reference oracle).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v,w: [B, S, H, D]; u: [H, D]; state: [B, H, D, D] (k-major).

    Returns (out [B, S, H, D] in r's dtype, final state [B, H, D, D] fp32).
    """
    B, S, H, D = r.shape
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf = u.float()
    s = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    outs = []
    for t in range(S):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]          # [B,H,Dk,Dv]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, t],
                                 s + uf[..., :, None] * kv))
        s = wf[:, t, :, :, None] * s + kv
    out = (torch.stack(outs, dim=1) if outs
           else torch.zeros((B, 0, H, D), device=r.device))
    return out.to(r.dtype), s
