"""Decode attention as a hand-written Hopper kernel
(``csrc/flash_decode.cu``), the port of the Pallas TPU kernel
``repro.kernels.flash_decode.kernel.flash_decode_pallas``.

The wrapper checks device, dtype, shape and contiguity, allocates the
output and the fp32 split partials with ``torch.empty``, launches on the
current stream and counts its launches in ``KERNEL.launches``. It takes CUDA
tensors only: the plain version for the CPU is
``flash_attention.ops._decode_partials``. ``lengths`` stays on the device;
the kernel reads each row's length itself, so no host sync happens here.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from .._build import CudaKernel, stream_ptr

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

KERNEL = CudaKernel(
    "flash_decode", Path(__file__).resolve().parent / "csrc" / "flash_decode.cu",
    "flash_decode_fwd",
    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
     _F, _P])

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT = 256            # cache positions per block; partials combine on device
MAX_GROUP = 32         # q heads per kv head that fit the shared-memory plan


def _check(q, k_cache, v_cache, lengths) -> None:
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if not t.is_cuda or t.device != q.device:
            raise ValueError(f"flash_decode: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors on one device only")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_decode: {name} must be contiguous and "
                             "16-byte aligned")
    if q.dtype not in DTYPES or k_cache.dtype not in DTYPES \
            or v_cache.dtype != k_cache.dtype:
        raise TypeError(f"flash_decode: q {q.dtype}, caches "
                        f"{k_cache.dtype}/{v_cache.dtype}; each must be "
                        "float32 or bfloat16, the two caches alike")
    if lengths.dtype != torch.int32:
        raise TypeError(f"flash_decode: lengths must be int32, got {lengths.dtype}")
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} must be [B,1,H,D], "
                         f"caches {tuple(k_cache.shape)} [B,L,KV,D]")
    B, _, H, D = q.shape
    if (k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != D or tuple(lengths.shape) != (B,)):
        raise ValueError(f"flash_decode: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)}/{tuple(v_cache.shape)}, "
                         f"lengths {tuple(lengths.shape)}")
    KV = k_cache.shape[2]
    if H % KV or H // KV > MAX_GROUP:
        raise ValueError(f"flash_decode: {H} q heads over {KV} kv heads")
    if D % 8 or not 8 <= D <= 256:
        raise ValueError(f"flash_decode: head dim {D} must be a multiple of 8 "
                         "in [8, 256]")


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, *,
                 window: int = 0, softcap: float = 0.0,
                 scale: Optional[float] = None) -> torch.Tensor:
    """q: [B,1,H,D]; caches [B,L,KV,D]; lengths [B] int32 -> [B,1,H,D]."""
    _check(q, k_cache, v_cache, lengths)
    B, _, H, D = q.shape
    L, KV = k_cache.shape[1], k_cache.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    out = torch.empty_like(q)
    if B == 0 or L == 0:
        return out.zero_()
    nsplit = -(-L // SPLIT)
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B, KV, nsplit, G, D), **f32)
    m = torch.empty((B, KV, nsplit, G), **f32)
    l = torch.empty((B, KV, nsplit, G), **f32)
    fn = KERNEL.fn()
    KERNEL.launches += 1
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            lengths.data_ptr(), acc.data_ptr(), m.data_ptr(), l.data_ptr(),
            out.data_ptr(), B, L, H, KV, D, DTYPES[q.dtype],
            DTYPES[k_cache.dtype], SPLIT, int(window), float(softcap),
            float(scale), stream_ptr(q))
    KERNEL.check(rc)
    return out
