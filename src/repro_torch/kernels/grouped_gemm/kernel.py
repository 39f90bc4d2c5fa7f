"""Ragged grouped GEMM as a hand-written Hopper kernel
(``csrc/grouped_gemm.cu``), the port of the Pallas TPU kernel
``repro.kernels.grouped_gemm.kernel.grouped_gemm_pallas``.

Three kernels, chosen in the C library by dtype and shape alone: bf16 that
TMA can map (D and F multiples of 8, 16-byte aligned) on ``wgmma`` fed by
TMA, other bf16 on ``mma.sync``, fp32 on the CUDA cores; ``variant`` names
the one a call takes.

The wrapper checks device, dtype, shape and contiguity, allocates the
output and the kernel's schedule scratch with ``torch.empty``, launches on
the current stream and counts its launches in ``KERNEL.launches``. The
group sizes stay on the device: the kernel scans them itself, so a call
never waits on the host. It takes CUDA tensors only: the plain version for
the CPU is ``ops._grouped_gemm_torch``.
The kernel has no backward: the wrapper raises when grad mode is on and
an input needs a gradient (``_build.refuse_autograd``).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from .._build import CudaKernel, refuse_autograd, stream_ptr

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    "grouped_gemm", Path(__file__).resolve().parent / "csrc" / "grouped_gemm.cu",
    "grouped_gemm_fwd", [_P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P])

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VARIANTS = ("fp32 CUDA cores", "bf16 mma.sync 64x128", "bf16 wgmma 128x256",
            "bf16 wgmma 256x128")
SIZE_DTYPES = (torch.int32, torch.int64)
INT_MAX = 2 ** 31 - 1


def _check(x: torch.Tensor, group_sizes: torch.Tensor, W: torch.Tensor) -> None:
    for name, t in (("x", x), ("group_sizes", group_sizes), ("W", W)):
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"grouped_gemm: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors on one device only")
        if not t.is_contiguous():
            raise ValueError(f"grouped_gemm: {name} must be contiguous")
    if x.dtype != W.dtype or x.dtype not in DTYPES:
        raise TypeError(f"grouped_gemm: x and W must both be float32 or both "
                        f"bfloat16, got {x.dtype}/{W.dtype}")
    if group_sizes.dtype not in SIZE_DTYPES:
        raise TypeError(f"grouped_gemm: group_sizes must be int32 or int64, "
                        f"got {group_sizes.dtype}")
    if (x.dim() != 2 or W.dim() != 3 or W.shape[1] != x.shape[1]
            or tuple(group_sizes.shape) != (W.shape[0],)):
        raise ValueError(f"grouped_gemm: x {tuple(x.shape)}, group_sizes "
                         f"{tuple(group_sizes.shape)}, W {tuple(W.shape)}; "
                         "expected [T, D], [E], [E, D, F]")
    if max(*x.shape, *W.shape) > INT_MAX:
        raise ValueError("grouped_gemm: a dimension exceeds 2**31 - 1")


def grouped_gemm(x: torch.Tensor, group_sizes: torch.Tensor,
                 W: torch.Tensor) -> torch.Tensor:
    """x: [T, D] sorted by group; group_sizes: [E] int32/int64 on x's
    device; W: [E, D, F] -> [T, F] in x's dtype, zero past the last group."""
    refuse_autograd("grouped_gemm", x, W)
    _check(x, group_sizes, W)
    T, D = x.shape
    E, _, F = W.shape
    out = torch.empty((T, F), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    sched = torch.empty(2 * (E + 2), dtype=torch.int32, device=x.device)
    fn = KERNEL.fn()
    KERNEL.count_launch()
    rc = fn(x.data_ptr(), group_sizes.data_ptr(),
            int(group_sizes.dtype == torch.int64), W.data_ptr(),
            out.data_ptr(), sched.data_ptr(), T, D, F, E, DTYPES[x.dtype],
            stream_ptr(x))
    KERNEL.check(rc)
    return out


def variant(x: torch.Tensor, group_sizes: torch.Tensor, W: torch.Tensor) -> str:
    """The GEMM kernel ``grouped_gemm`` launches for these arguments, as the
    C library chooses it (its output is allocated 16-byte aligned)."""
    _check(x, group_sizes, W)
    T, D = x.shape
    E, _, F = W.shape
    fn = KERNEL.entry("grouped_gemm_variant", [_P, _P, _P, _I, _I, _I, _I, _I])
    return VARIANTS[fn(x.data_ptr(), W.data_ptr(), None, T, D, F, E,
                       DTYPES[x.dtype])]
