"""Mamba selective scan as a hand-written Hopper kernel
(``csrc/mamba_scan.cu``), the port of the Pallas TPU kernel
``repro.kernels.mamba_scan.kernel.mamba_scan_pallas``.

The wrapper checks device, dtype, shape and contiguity, allocates ``y`` and
the final state with ``torch.empty``, launches on the current stream and
counts its launches in ``KERNEL.launches``. It takes CUDA tensors only: the
plain version for the CPU is ``ops._mamba_torch``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .._build import CudaKernel, stream_ptr

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    "mamba_scan", Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu",
    "mamba_scan_fwd", [_P] * 9 + [_I] * 4 + [_P])

STATE_SIZES = (2, 4, 8, 16, 32)     # lanes of one warp, a power of two


def _check(x, dt, A, B, C, D, state) -> None:
    named = [("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C), ("D", D)]
    if state is not None:
        named.append(("state", state))
    for name, t in named:
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"mamba_scan: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors on one device only")
        if t.dtype != torch.float32:
            raise TypeError(f"mamba_scan: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"mamba_scan: {name} must be contiguous")
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"mamba_scan: x {tuple(x.shape)} must be [Bt,S,DI], "
                         f"A {tuple(A.shape)} [DI,N]")
    Bt, S, DI = x.shape
    N = A.shape[1]
    if (dt.shape != x.shape or A.shape[0] != DI or tuple(D.shape) != (DI,)
            or tuple(B.shape) != (Bt, S, N) or C.shape != B.shape):
        raise ValueError(f"mamba_scan: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, "
                         f"C {tuple(C.shape)}, D {tuple(D.shape)}")
    if state is not None and tuple(state.shape) != (Bt, DI, N):
        raise ValueError(f"mamba_scan: state {tuple(state.shape)}, expected "
                         f"{(Bt, DI, N)}")
    if N not in STATE_SIZES:
        raise ValueError(f"mamba_scan: state size {N} not in {STATE_SIZES}")


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: [Bt,S,DI]; A: [DI,N]; B, C: [Bt,S,N]; D: [DI]; state:
    [Bt,DI,N] or None; all fp32. Returns (y [Bt,S,DI], state [Bt,DI,N])."""
    _check(x, dt, A, B, C, D, state)
    Bt, S, DI = x.shape
    N = A.shape[1]
    y = torch.empty_like(x)
    h_out = torch.empty((Bt, DI, N), dtype=torch.float32, device=x.device)
    if Bt * DI == 0:
        return y, h_out
    fn = KERNEL.fn()
    KERNEL.launches += 1
    rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(),
            None if state is None else state.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), Bt, S, DI, N, stream_ptr(x))
    KERNEL.check(rc)
    return y, h_out
