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

from torch.distributed.tensor import DTensor

from ..kernels.mamba_scan import ops as scan_ops
from ..sharding import collectives as col
from ..sharding.api import active_rules, shard
from .config import ModelConfig
from .layers import Param, dense_axes, dense_spec, matmul


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


def mamba_block_axes(cfg: ModelConfig) -> Dict[str, Any]:
    return {"in_proj": dense_axes("embed", "inner"),
            "conv_w": (None, "inner"),
            "conv_b": ("inner",),
            "x_proj": dense_axes("inner", None),
            "dt_proj": dense_axes(None, "inner", bias=True),
            "A_log": ("inner", None),
            "D": ("inner",),
            "out_proj": dense_axes("inner", "embed")}


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
    xz = matmul(x.to(compute_dtype), p["in_proj"]["w"].to(compute_dtype))
    xi, z = xz.chunk(2, dim=-1)                      # [B,S,DI] each
    xi = shard(xi, "batch", "act_seq", "inner")
    z = shard(z, "batch", "act_seq", "inner")

    xc, conv_state = _causal_conv(xi.float(), p["conv_w"], p["conv_b"],
                                  conv_state)
    xc = F.silu(xc)

    dbc = matmul(xc.to(compute_dtype),
                 p["x_proj"]["w"].to(compute_dtype)).float()
    dt_raw, Bc, Cc = torch.split(dbc, [dtr, n, n], dim=-1)
    dt = F.softplus(matmul(dt_raw, p["dt_proj"]["w"].float())
                    + p["dt_proj"]["b"])
    A = -torch.exp(p["A_log"])

    def scan(xc, dt, A, Bc, Cc, D, ssm_state):
        if S == 1 and ssm_state is not None:
            y, ssm_state = scan_ops.mamba_decode_step(
                xc[:, 0], dt[:, 0], A, Bc[:, 0], Cc[:, 0], D, ssm_state)
            return y[:, None], ssm_state
        return scan_ops.mamba_scan(xc.contiguous(), dt.contiguous(), A,
                                   Bc.contiguous(), Cc.contiguous(), D,
                                   ssm_state, impl=impl)

    args = (xc, dt, A, Bc, Cc, p["D"], ssm_state)
    rules = active_rules()
    if rules is None or not isinstance(xc, DTensor):
        y, ssm_state = scan(*args)
    else:   # the scan on this rank's rows and "inner" channels, whole seq
        mesh = xc.device_mesh
        b = rules.bound("batch")
        inner = rules.bindings.get("inner")
        seq = col.layout(mesh, {b: 0, inner: 2})
        state = col.layout(mesh, {b: 0, inner: 1})
        y, ssm_state = col.local_call(
            scan, mesh, args,
            (seq, seq, col.layout(mesh, {inner: 0}), col.layout(mesh, {b: 0}),
             col.layout(mesh, {b: 0}), col.layout(mesh, {inner: 0}), state),
            (seq, state))
    y = y.float() * F.silu(z.float())
    out = matmul(y.to(compute_dtype), p["out_proj"]["w"].to(compute_dtype))
    return shard(out, "batch", "seq", "embed"), conv_state, ssm_state
