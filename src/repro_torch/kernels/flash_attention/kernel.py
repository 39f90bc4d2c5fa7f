"""Prefill flash attention as a hand-written Hopper kernel
(``csrc/flash_attention.cu``), the port of the Pallas TPU kernel
``repro.kernels.flash_attention.kernel.flash_attention``. bf16 inputs run
on the tensor cores (``wgmma``, K/V tiles loaded by TMA); fp32 inputs on the
CUDA cores, in full fp32.

The wrapper checks device, dtype, shape and contiguity, allocates the
output with ``torch.empty``, launches on the current stream and counts its
launches in ``KERNEL.launches``. It takes CUDA tensors only: the plain
version for the CPU is ``ops._mha_torch``. With ``return_lse`` it also
returns each row's fp32 log-sum-exp, the residual training saves
(``ops.MhaFunction``). The kernel has no backward, so the wrapper refuses
inputs that need a gradient: its output, filled through ctypes, would have
no ``grad_fn`` and the gradient would silently stop there.
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

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 128, 256)


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
