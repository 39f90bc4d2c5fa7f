"""Plain PyTorch oracle for the Mamba selective-SSM scan: the exact
per-step recurrence (twin of ``repro.kernels.mamba_scan.ref``).

h_t = da_t * h_{t-1} + db_t ;  y_t = (C_t . h_t) + D * x_t
with da = exp(dt * A), db = dt * B_t * x_t (per channel and state).

dt*A is clamped to [-LOG_DECAY_CLAMP, -1e-8], as in the reference oracle
(which, unlike the chunked forms, clamps without the ``dt > 0`` guard; the
two agree for dt > 0, which softplus guarantees in the model).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

LOG_DECAY_CLAMP = 5.0


def mamba_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: [Bt, S, DI]; A: [DI, N]; B, C: [Bt, S, N]; D: [DI].

    Returns (y [Bt, S, DI] in x's dtype, final state [Bt, DI, N] fp32).
    """
    Bt, S, DI = x.shape
    N = A.shape[-1]
    xf, dtf, Bf, Cf = (t.float() for t in (x, dt, B, C))
    Af, Df = A.float(), D.float()
    h = (torch.zeros((Bt, DI, N), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    ys = []
    for t in range(S):
        lda = (dtf[:, t, :, None] * Af[None]).clamp(-LOG_DECAY_CLAMP, -1e-8)
        db = dtf[:, t, :, None] * Bf[:, t, None, :] * xf[:, t, :, None]
        h = torch.exp(lda) * h + db
        ys.append(torch.einsum("bdn,bn->bd", h, Cf[:, t]) + Df * xf[:, t])
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((Bt, 0, DI), device=x.device))
    return y.to(x.dtype), h
