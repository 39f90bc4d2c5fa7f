"""Mamba block (twin of ``repro.models.mamba``; jamba's "m" layers).

in_proj -> (x, z); causal depthwise conv + silu; data-dependent (dt, B, C),
each RMS-normalised with a learned scale where ``cfg.mamba_inner_norms``
(HF ``JambaMambaMixer``: jamba2; the JAX package has no such norms);
the selective scan through ``kernels/mamba_scan`` (the Hopper kernel for
CUDA tensors, the chunked plain version on the CPU; a single token
against a state takes ``mamba_decode_step``); gate with silu(z); out_proj.
Decode carries (conv_state [B, d_conv-1, DI], ssm_state [B, DI, N]).
A prefill of right-padded rows passes each row's true length: the pad
steps get dt = 0, so they neither decay nor add to the state, and the conv
state is read at each row's length, so both states are those of the row
alone (the unsharded path; the serving engine's padded admission).
The body runs inside a ``torch.profiler.record_function("mamba")`` range.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor
from torch.profiler import record_function

from ..kernels.mamba_scan import ops as scan_ops
from ..sharding import collectives as col
from ..sharding.api import active_rules, shard
from .config import ModelConfig
from .layers import Param, dense_axes, dense_spec, matmul, rms_norm

INNER_NORMS = ("dt_norm", "b_norm", "c_norm")


def init_mamba_block(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's parameter tree (``repro.models.mamba.init_mamba_block``)
    as :class:`Param` specs; ``transformer.init_params`` creates them."""
    d, di, n = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
    dc, dtr = cfg.mamba_d_conv, cfg.dt_rank
    spec = {
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
    if cfg.mamba_inner_norms:       # scales of ones, as HF's JambaRMSNorm
        for name, width in zip(INNER_NORMS, (dtr, n, n)):
            spec[name] = Param((width,), value=1.0)
    return spec


def mamba_block_axes(cfg: ModelConfig) -> Dict[str, Any]:
    axes = {"in_proj": dense_axes("embed", "inner"),
            "conv_w": (None, "inner"),
            "conv_b": ("inner",),
            "x_proj": dense_axes("inner", None),
            "dt_proj": dense_axes(None, "inner", bias=True),
            "A_log": ("inner", None),
            "D": ("inner",),
            "out_proj": dense_axes("inner", "embed")}
    if cfg.mamba_inner_norms:       # replicated: each rank's whole (dt, B, C)
        axes.update({name: (None,) for name in INNER_NORMS})
    return axes


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prev: Optional[torch.Tensor] = None,
                 lengths: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x [B,S,DI]; w [dc,DI]. Returns (y, new_state);
    with ``lengths`` [B] the state holds the dc-1 inputs before each row's
    length, not the last ones."""
    dc = w.shape[0]
    S = x.shape[1]
    if prev is None:
        prev = torch.zeros((x.shape[0], dc - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([prev, x], dim=1)                 # [B, S+dc-1, DI]
    y = sum(xp[:, i:i + S] * w[i][None, None] for i in range(dc))
    if dc == 1:
        new_state = prev
    elif lengths is None:
        new_state = xp[:, -(dc - 1):]
    else:   # inputs [L, L + dc - 1) of xp: the last dc-1 before length L
        idx = (lengths.long()[:, None]
               + torch.arange(dc - 1, device=x.device)[None, :])
        new_state = xp.gather(1, idx[..., None].expand(-1, -1, x.shape[2]))
    return y + b[None, None], new_state


def mamba_apply(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
                conv_state: Optional[torch.Tensor] = None,
                ssm_state: Optional[torch.Tensor] = None,
                lengths: Optional[torch.Tensor] = None,
                impl: Optional[str] = None, compute_dtype=torch.bfloat16):
    """x: [B, S, D]. Returns (out, new_conv_state, new_ssm_state).
    ``lengths`` [B]: the true lengths of right-padded rows in a prefill
    (S > 1, unsharded); the states returned are then each row's at its
    length."""
    with record_function("mamba"):
        return _mamba_body(p, x, cfg, conv_state, ssm_state, lengths, impl,
                           compute_dtype)


def _mamba_body(p, x, cfg: ModelConfig, conv_state, ssm_state, lengths,
                impl, compute_dtype):
    S = x.shape[1]
    if S == 1 or isinstance(x, DTensor):
        lengths = None
    n, dtr = cfg.mamba_d_state, cfg.dt_rank
    xz = matmul(x.to(compute_dtype), p["in_proj"]["w"].to(compute_dtype))
    xi, z = xz.chunk(2, dim=-1)                      # [B,S,DI] each
    xi = shard(xi, "batch", "act_seq", "inner")
    z = shard(z, "batch", "act_seq", "inner")

    xc, conv_state = _causal_conv(xi.float(), p["conv_w"], p["conv_b"],
                                  conv_state, lengths)
    xc = F.silu(xc)

    dbc = matmul(xc.to(compute_dtype),
                 p["x_proj"]["w"].to(compute_dtype)).float()
    dt_raw, Bc, Cc = torch.split(dbc, [dtr, n, n], dim=-1)
    if cfg.mamba_inner_norms:       # the scan and the one-token step alike
        eps = cfg.norm_eps
        dt_raw = rms_norm(dt_raw, p["dt_norm"], eps)
        Bc = rms_norm(Bc, p["b_norm"], eps)
        Cc = rms_norm(Cc, p["c_norm"], eps)
    dt = F.softplus(matmul(dt_raw, p["dt_proj"]["w"].float())
                    + p["dt_proj"]["b"])
    if lengths is not None:     # pad steps: no decay, no input
        valid = (torch.arange(S, device=dt.device)[None, :]
                 < lengths.to(dt.device)[:, None])
        dt = torch.where(valid[..., None], dt, 0.0)
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
