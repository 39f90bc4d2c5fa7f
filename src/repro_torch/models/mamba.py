"""Mamba block (twin of ``repro.models.mamba``; jamba's "m" layers).

in_proj -> (x, z); causal depthwise conv + silu; data-dependent (dt, B, C);
the selective scan through ``kernels/mamba_scan`` (the Hopper kernel for
CUDA tensors, the chunked plain version on the CPU; a single token
against a state takes ``mamba_decode_step``); gate with silu(z); out_proj.
Decode carries (conv_state [B, d_conv-1, DI], ssm_state [B, DI, N]).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels.mamba_scan import ops as scan_ops
from .config import ModelConfig
from .layers import Param, dense_spec


def init_mamba_block(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's parameter tree (``repro.models.mamba.init_mamba_block``)
    as :class:`Param` specs; ``transformer.init_params`` creates them."""
    d, di, n = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    dc, dtr = cfg.mamba_d_conv, cfg.dt_rank
    return {
        "in_proj": dense_spec(d, 2 * di),
        "conv_w": Param((dc, di), dc ** -0.5),
        "conv_b": Param((di,)),
        "x_proj": dense_spec(di, dtr + 2 * n),
        # mamba.py:83 of the reference reads dt_proj.w in fp32
        "dt_proj": dense_spec(dtr, di, bias=True, compute=False),
        "A_log": Param((di, n), fill=lambda: torch.log(
            torch.arange(1, n + 1, dtype=torch.float32)).expand(di, n)),
        "D": Param((di,), value=1.0),
        "out_proj": dense_spec(di, d, stddev=di ** -0.5),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x [B,S,DI]; w [dc,DI]. Returns (y, new_state)."""
    dc = w.shape[0]
    S = x.shape[1]
    if prev is None:
        prev = torch.zeros((x.shape[0], dc - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev, x], dim=1)                 # [B, S+dc-1, DI]
    y = sum(xp[:, i:i + S] * w[i][None, None] for i in range(dc))
    new_state = xp[:, -(dc - 1):] if dc > 1 else prev
    return y + b[None, None], new_state


def mamba_apply(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
                conv_state: Optional[torch.Tensor] = None,
                ssm_state: Optional[torch.Tensor] = None,
                impl: Optional[str] = None, compute_dtype=torch.bfloat16):
    """x: [B, S, D]. Returns (out, new_conv_state, new_ssm_state)."""
    S = x.shape[1]
    n, dtr = cfg.mamba_d_state, cfg.dt_rank
    xz = x.to(compute_dtype) @ p["in_proj"]["w"].to(compute_dtype)
    xi, z = xz.chunk(2, dim=-1)                      # [B,S,DI] each

    xc, conv_state = _causal_conv(xi.float(), p["conv_w"], p["conv_b"],
                                  conv_state)
    xc = F.silu(xc)

    dbc = (xc.to(compute_dtype)
           @ p["x_proj"]["w"].to(compute_dtype)).float()
    dt_raw, Bc, Cc = torch.split(dbc, [dtr, n, n], dim=-1)
    dt = F.softplus(dt_raw @ p["dt_proj"]["w"].float() + p["dt_proj"]["b"])
    A = -torch.exp(p["A_log"])

    if S == 1 and ssm_state is not None:
        y, ssm_state = scan_ops.mamba_decode_step(
            xc[:, 0], dt[:, 0], A, Bc[:, 0], Cc[:, 0], p["D"], ssm_state)
        y = y[:, None]
    else:
        y, ssm_state = scan_ops.mamba_scan(
            xc, dt, A, Bc.contiguous(), Cc.contiguous(), p["D"], ssm_state,
            impl=impl)
    y = y.float() * F.silu(z.float())
    out = y.to(compute_dtype) @ p["out_proj"]["w"].to(compute_dtype)
    return out, conv_state, ssm_state
