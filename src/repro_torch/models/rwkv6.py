"""RWKV6 "Finch" block (twin of ``repro.models.rwkv6``): data-dependent
decay time mixing and squared-ReLU channel mixing.

Token shift with data-dependent linear interpolation (ddlerp, low-rank),
decay w = exp(-exp(.)) from a LoRA per token and channel, bonus u, a
per-head wkv state of head_size x head_size, group norm on the wkv output.
The wkv recurrence runs through ``kernels/rwkv6_scan`` (the Hopper kernel
for CUDA tensors, the chunked plain version on the CPU); a single token
against a state (decode, or a one-token prompt) takes
``rwkv6_decode_step``. Decode carries (shift_tm, shift_cm, wkv_state).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from torch.distributed.tensor import DTensor, Replicate, Shard

from ..kernels.rwkv6_scan import ops as wkv_ops
from ..sharding import collectives as col
from ..sharding.api import active_rules, shard
from .config import ModelConfig
from .layers import Param, dense_axes, dense_spec, group_norm, matmul

LORA_MIX = 32
LORA_DECAY = 64


def init_rwkv_block(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's parameter tree (``repro.models.rwkv6.init_rwkv_block``)
    as :class:`Param` specs; ``transformer.init_params`` creates them."""
    d, hs = cfg.d_model, cfg.rwkv_head_size
    H = d // hs
    return {
        "tm": {
            "maa_x": Param((d,)),
            "maa": Param((5, d)),                          # w, k, v, r, g
            "mix_w1": Param((d, 5 * LORA_MIX), 1e-2),
            "mix_w2": Param((5, LORA_MIX, d), 1e-2),
            "decay_w0": Param((d,), value=-1.0),
            "decay_w1": Param((d, LORA_DECAY), 1e-2),
            "decay_w2": Param((LORA_DECAY, d), 1e-2),
            "bonus": Param((H, hs), 0.1),
            "wr": dense_spec(d, d), "wk": dense_spec(d, d),
            "wv": dense_spec(d, d), "wg": dense_spec(d, d),
            "wo": dense_spec(d, d),
            "gn_scale": Param((d,), value=1.0),
            "gn_bias": Param((d,)),
        },
        "cm": {
            "maa_k": Param((d,)),
            "maa_r": Param((d,)),
            "wk": dense_spec(d, cfg.d_ff),
            "wv": dense_spec(cfg.d_ff, d, stddev=cfg.d_ff ** -0.5),
            "wr": dense_spec(d, d),
        },
    }


def rwkv_block_axes(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "tm": {
            "maa_x": (None,), "maa": (None, None),
            "mix_w1": (None, None), "mix_w2": (None, None, None),
            "decay_w0": (None,), "decay_w1": (None, None),
            "decay_w2": (None, None),
            "bonus": ("heads", None),
            "wr": dense_axes("embed", "heads_flat"),
            "wk": dense_axes("embed", "heads_flat"),
            "wv": dense_axes("embed", "heads_flat"),
            "wg": dense_axes("embed", "heads_flat"),
            "wo": dense_axes("heads_flat", "embed"),
            "gn_scale": (None,), "gn_bias": (None,),
        },
        "cm": {
            "maa_k": (None,), "maa_r": (None,),
            "wk": dense_axes("embed", "mlp"),
            "wv": dense_axes("mlp", "embed"),
            "wr": dense_axes("embed", "embed2"),
        },
    }


def _token_shift(x: torch.Tensor,
                 prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Shift right by one along seq; position 0 gets ``prev`` (or zeros)."""
    if x.shape[1] == 1:
        return prev if prev is not None else torch.zeros_like(x)
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    if prev is not None:
        shifted[:, 0:1] = prev
    return shifted


def _mix(lora: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """The LoRA's second product [B, S, 5, L] x [5, L, D] -> [B, S, 5, D];
    for a DTensor, on each rank's rows with w2 whole."""
    def mix(a, b):
        return torch.einsum("bsfl,fld->bsfd", a, b)
    if not isinstance(lora, DTensor):
        return mix(lora, w2)
    mesh = lora.device_mesh
    rows = tuple(p if p == Shard(0) else Replicate() for p in lora.placements)
    return col.local_call(mix, mesh, (lora, w2),
                          (rows, (Replicate(),) * mesh.ndim), rows)


def time_mix(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
             shift_state: Optional[torch.Tensor] = None,
             wkv_state: Optional[torch.Tensor] = None,
             impl: Optional[str] = None, compute_dtype=torch.bfloat16):
    """Returns (out, new_shift_state, new_wkv_state)."""
    B, S, D = x.shape
    hs = cfg.rwkv_head_size
    H = D // hs
    xf = x.float()
    dx = _token_shift(xf, shift_state) - xf
    tm = p["tm"]

    # ddlerp: data-dependent interpolation coefficients from a LoRA. The
    # LoRA products are fp32, with bf16 weights (the train step's copies)
    # upcast as the reference's type promotion does
    xxx = xf + dx * tm["maa_x"]
    lora = torch.tanh(shard(matmul(xxx, tm["mix_w1"].float()), "batch", None,
                            None)).reshape(B, S, 5, LORA_MIX)
    mix = _mix(lora, tm["mix_w2"].float())
    maa = tm["maa"][None, None]
    xw, xk, xv, xr, xg = [
        (xf + dx * (maa[:, :, i] + mix[:, :, i])).to(compute_dtype)
        for i in range(5)]

    def proj(t, name):
        return matmul(t, tm[name]["w"].to(compute_dtype))

    def heads(t, name):   # laid out by heads before the split (no-op
        # without rules)
        return shard(proj(t, name), "batch", "attn_seq",
                     "heads").reshape(B, S, H, hs)

    r, k, v = heads(xr, "wr"), heads(xk, "wk"), heads(xv, "wv")
    g = F.silu(proj(xg, "wg").float())

    # data-dependent decay, clamped into the numerically safe band
    dlog = tm["decay_w0"] + matmul(torch.tanh(matmul(
        xw.float(), tm["decay_w1"].float())), tm["decay_w2"].float())  # [B,S,D]
    neg = (-torch.exp(dlog)).clamp(-wkv_ops.LOG_DECAY_CLAMP, -1e-6)
    w = shard(torch.exp(neg), "batch", "attn_seq", "heads").reshape(B, S, H, hs)

    r = shard(r, "batch", "attn_seq", "heads", None)
    k = shard(k, "batch", "attn_seq", "heads", None)
    v = shard(v, "batch", "attn_seq", "heads", None)

    def scan(r, k, v, w, u, wkv_state):
        if S == 1 and wkv_state is not None:
            out, wkv_state = wkv_ops.rwkv6_decode_step(
                r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, wkv_state)
            return out[:, None], wkv_state
        return wkv_ops.rwkv6_scan(r.contiguous(), k.contiguous(),
                                  v.contiguous(), w.contiguous(), u,
                                  wkv_state, impl=impl)

    args = (r, k, v, w, tm["bonus"], wkv_state)
    rules = active_rules()
    if rules is None or not isinstance(r, DTensor):
        out, wkv_state = scan(*args)
    else:   # the scan on this rank's rows and heads, whole seq
        mesh = r.device_mesh
        b = rules.bound("batch")
        heads = rules.bindings.get("heads")
        seq = col.layout(mesh, {b: 0, heads: 2})
        state = col.layout(mesh, {b: 0, heads: 1})
        out, wkv_state = col.local_call(
            scan, mesh, args,
            (seq, seq, seq, seq, col.layout(mesh, {heads: 0}), state),
            (seq, state))
    out = group_norm(out.reshape(B, S, D), tm["gn_scale"], tm["gn_bias"],
                     num_groups=H)
    out = (out.float() * g).to(compute_dtype)
    return shard(proj(out, "wo"), "batch", "seq", "embed"), xf[:, -1:], \
        wkv_state


def channel_mix(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig, *,
                shift_state: Optional[torch.Tensor] = None,
                compute_dtype=torch.bfloat16):
    """Squared-ReLU channel mix. Returns (out, new_shift_state)."""
    xf = x.float()
    dx = _token_shift(xf, shift_state) - xf
    cm = p["cm"]
    xk = (xf + dx * cm["maa_k"]).to(compute_dtype)
    xr = (xf + dx * cm["maa_r"]).to(compute_dtype)
    k = matmul(xk, cm["wk"]["w"].to(compute_dtype))
    k = torch.square(F.relu(k.float())).to(compute_dtype)
    k = shard(k, "batch", "act_seq", "mlp")
    v = matmul(k, cm["wv"]["w"].to(compute_dtype))
    rgate = torch.sigmoid(matmul(xr, cm["wr"]["w"].to(compute_dtype)).float())
    return (rgate * v.float()).to(compute_dtype), xf[:, -1:]
