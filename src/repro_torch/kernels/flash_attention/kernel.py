"""Prefill flash attention as hand-written Hopper kernels: the forward
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention``, and its backward
(``csrc/flash_attention_bwd.cu``), the port of the reference's
``_mha_bwd_impl``. bf16 inputs run on the tensor cores (``wgmma``, tiles
loaded by TMA); fp32 inputs on the CUDA cores, in full fp32.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs (and the backward its scratch) with ``torch.empty``, launches on the
current stream and counts its launches (``KERNEL.launches`` for the forward,
``BWD_KERNEL.launches`` for the backward). They take CUDA tensors only: the
plain versions for the CPU are ``ops._mha_torch`` and ``ops._mha_bwd_torch``.
With ``return_lse`` the forward also returns each row's fp32 log-sum-exp,
the residual that training saves and ``flash_attention_bwd`` takes
(``ops.MhaFunction`` calls both). Neither wrapper is itself differentiable:
each refuses inputs that need a gradient under grad mode, since its
outputs, filled through ctypes, would have no ``grad_fn`` and the gradient
would silently stop there.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .._build import CudaKernel, refuse_autograd, stream_ptr

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel(
    "flash_attention", Path(__file__).resolve().parent / "csrc" / "flash_attention.cu",
    "flash_attention_fwd",
    [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I, _P])

BWD_KERNEL = CudaKernel(
    "flash_attention_bwd",
    Path(__file__).resolve().parent / "csrc" / "flash_attention_bwd.cu",
    "flash_attention_bwd",
    [_P] * 11 + [_I] * 9 + [_F, _F, _I, _P])

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)
ROW_PAD = 128    # the backward's lse/delta scratch rows: S rounded up to this


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             "the kernel takes CUDA tensors only")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"flash_attention: q/k/v must all be float32 or all "
                            f"bfloat16, got {q.dtype}/{k.dtype}/{v.dtype}")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be a contiguous, "
                             f"16-byte aligned 4-D tensor, got {tuple(t.shape)}")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"flash_attention: {H} q heads not a multiple of "
                         f"{k.shape[2]} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {HEAD_DIMS}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0, scale: Optional[float] = None,
                    q_offset: int = 0, return_lse: bool = False):
    """q: [B, S, H, D]; k, v: [B, T, KV, D] -> out [B, S, H, D] in
    q.dtype, and with ``return_lse`` also lse [B, S, H] fp32
    (``m + log(max(l, 1e-30))``, natural log)."""
    refuse_autograd("flash_attention", q, k, v)
    _check(q, k, v)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    lse = (torch.empty((B, S, H), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() > 0:
        fn = KERNEL.fn()
        KERNEL.count_launch()
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(),
                B, S, T, H, KV, D, DTYPES[q.dtype], int(causal), int(window),
                float(softcap), float(scale), int(q_offset), stream_ptr(q))
        KERNEL.check(rc)
    return (out, lse) if return_lse else out


def _check_bwd(q, k, v, out, lse, dout) -> None:
    """The backward's checks, dtypes and shapes before the device, so that
    each refusal is seen on the CPU too."""
    named = (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout))
    if q.dtype not in DTYPES or any(t.dtype != q.dtype for _, t in named):
        raise TypeError("flash_attention_bwd: q/k/v/out/dout must all be "
                        "float32 or all bfloat16, got "
                        + "/".join(str(t.dtype) for _, t in named))
    if lse.dtype != torch.float32:
        raise TypeError(f"flash_attention_bwd: lse must be float32, got {lse.dtype}")
    if any(t.dim() != 4 for _, t in named):
        raise ValueError("flash_attention_bwd: q/k/v/out/dout must be 4-D")
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)} vs k "
                         f"{tuple(k.shape)} / v {tuple(v.shape)}")
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: out {tuple(out.shape)} and dout "
                         f"{tuple(dout.shape)} must match q {tuple(q.shape)}")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention_bwd: {H} q heads not a multiple of "
                         f"{KV} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {D} not in {HEAD_DIMS}")
    if tuple(lse.shape) not in ((B, S, H), (B, S, KV, H // KV)) \
            or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"[B, S, H] or [B, S, KV, G], got {tuple(lse.shape)}")
    for name, t in named + (("lse", lse),):
        if not t.is_cuda:
            raise ValueError(f"flash_attention_bwd: {name} is on {t.device}, "
                             "the kernel takes CUDA tensors only")
        if t.device != q.device:
            raise ValueError(f"flash_attention_bwd: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_bwd: {name} must be contiguous "
                             "and 16-byte aligned")


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0,
                        scale: Optional[float] = None, q_offset: int = 0):
    """The gradients of ``flash_attention``: q, out, dout [B, S, H, D]; k, v
    [B, T, KV, D]; lse fp32 [B, S, H] (or [B, S, KV, G]), the forward's
    ``return_lse``. Returns (dq, dk, dv) in the inputs' dtype, the products'
    contract of ``ops._mha_bwd_torch``: bf16 operands, p and ds rounded to
    the input dtype before their products, fp32 scores and sums."""
    refuse_autograd("flash_attention_bwd", q, k, v, out, dout)
    _check_bwd(q, k, v, out, lse, dout)
    B, S, H, D = q.shape
    T, KV = k.shape[1], k.shape[2]
    scale = scale if scale is not None else D ** -0.5
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if dq.numel() > 0 or dk.numel() > 0:
        sp = -(-S // ROW_PAD) * ROW_PAD
        lse2 = torch.empty((B, H, sp), dtype=torch.float32, device=q.device)
        delta = torch.empty_like(lse2)
        fn = BWD_KERNEL.fn()
        BWD_KERNEL.count_launch()
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                dv.data_ptr(), lse2.data_ptr(), delta.data_ptr(),
                B, S, T, H, KV, D, DTYPES[q.dtype], int(causal), int(window),
                float(softcap), float(scale), int(q_offset), stream_ptr(q))
        BWD_KERNEL.check(rc)
    return dq, dk, dv
