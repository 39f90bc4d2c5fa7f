"""Mamba selective scan as a hand-written Hopper kernel
(``csrc/mamba_scan.cu``), the port of the Pallas TPU kernel
``repro.kernels.mamba_scan.kernel.mamba_scan_pallas``.

At state sizes 4-32 with d_inner a multiple of 4 (the served case) the
kernel keeps each channel's states in the registers of 1, 2 or 4 lanes and
is fed by TMA; other shapes take the per-step kernel (one lane per state).
``plan`` names the kernel and the lanes per channel a call takes.

The wrapper checks device, dtype, shape, contiguity and alignment,
allocates ``y`` and the final state with ``torch.empty``, launches one
kernel on the current stream and counts its launches in
``KERNEL.launches``. It takes CUDA tensors only: the
plain version for the CPU is ``ops._mamba_torch``.
The kernel has no backward: the wrapper raises when grad mode is on and
an input needs a gradient (``_build.refuse_autograd``). Training calls it
from ``ops.MambaScanFunction``'s forward, one launch a group of chunks, its
state in and out carrying the scan from one group to the next.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from .._build import CudaKernel, refuse_autograd, sm_count, stream_ptr

_P, _I = ctypes.c_void_p, ctypes.c_int

KERNEL = CudaKernel(
    "mamba_scan", Path(__file__).resolve().parent / "csrc" / "mamba_scan.cu",
    "mamba_scan_fwd", [_P] * 9 + [_I] * 5 + [_P])

STATE_SIZES = (2, 4, 8, 16, 32)     # lanes of one warp, a power of two
TILE_STATE_SIZES = (4, 8, 16, 32)   # the TMA-fed kernel's (16-byte rows of B, C)
TILE = 16                           # steps per tile of either kernel
BLOCK_THREADS = 128                 # TMA-fed kernel: channels x lanes per block
WARPS_PER_SM = 6                    # TMA-fed kernel: lanes per channel until this many fit


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
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"mamba_scan: {name} must be contiguous and "
                             "16-byte aligned")
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


def plan(Bt: int, S: int, DI: int, N: int, sms: int) -> dict:
    """The kernel a call of this shape takes, as the C library chooses it
    (``mamba_scan_variant``), and its lanes.

    ``kernel`` is "tiles" (N in ``TILE_STATE_SIZES``, DI a multiple of 4,
    S >= 1: TMA-fed, states in registers) or "per-step" (one lane per
    state); ``lanes`` the lanes that share one channel's N states and
    ``channels`` the channels of one block. The TMA-fed kernel takes the
    fewest lanes (1, 2 or 4, at most N) that still give ``WARPS_PER_SM``
    warps on every SM; more lanes per channel cost shuffles on every step,
    fewer leave the SMs without warps to switch to at B 1."""
    if S >= 1 and DI % 4 == 0 and N in TILE_STATE_SIZES:
        lanes = 1
        while Bt * DI * lanes < WARPS_PER_SM * 32 * sms and lanes < min(4, N):
            lanes *= 2
        return {"kernel": "tiles", "tile": TILE, "lanes": lanes,
                "channels": BLOCK_THREADS // lanes}
    return {"kernel": "per-step", "tile": TILE, "lanes": N,
            "channels": 256 // N}


def variant(x: torch.Tensor, N: int) -> str:
    """The kernel ``mamba_scan`` launches for x's shape and N states, as the
    C library chooses it."""
    fn = KERNEL.entry("mamba_scan_variant", [_I, _I, _I])
    Bt, S, DI = x.shape
    return ("TMA-fed, states in registers" if fn(S, DI, N)
            else "per-step, one lane per state")


def mamba_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
               B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt: [Bt,S,DI]; A: [DI,N]; B, C: [Bt,S,N]; D: [DI]; state:
    [Bt,DI,N] or None; all fp32. Returns (y [Bt,S,DI], state [Bt,DI,N])."""
    refuse_autograd("mamba_scan", x, dt, A, B, C, D, state)
    _check(x, dt, A, B, C, D, state)
    Bt, S, DI = x.shape
    N = A.shape[1]
    y = torch.empty_like(x)
    h_out = torch.empty((Bt, DI, N), dtype=torch.float32, device=x.device)
    if Bt * DI == 0:
        return y, h_out
    lanes = plan(Bt, S, DI, N, sm_count(x.device.index))["lanes"]
    fn = KERNEL.fn()
    KERNEL.count_launch()
    rc = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), D.data_ptr(),
            None if state is None else state.data_ptr(), y.data_ptr(),
            h_out.data_ptr(), Bt, S, DI, N, lanes, stream_ptr(x))
    KERNEL.check(rc)
    return y, h_out
