"""RWKV6 wkv scan as a hand-written Hopper kernel (``csrc/rwkv6_scan.cu``),
the port of the Pallas TPU kernel
``repro.kernels.rwkv6_scan.kernel.rwkv6_scan_pallas``.

bf16 r/k/v with a head size of 16, 32, 64 or 128 run the chunked form on
the tensor cores (mma.sync, TMA-fed tiles of 16 steps); fp32 r/k/v and
head size 8 run the exact per-step recurrence on the CUDA cores. ``plan``
names the kernel and the v split a call takes.

The wrapper checks device, dtype, shape, contiguity and alignment,
allocates the output and the final state with ``torch.empty``, launches
one kernel on the current stream and counts its launches in
``KERNEL.launches``. It takes CUDA tensors only: the plain version for
the CPU is ``ops._rwkv6_torch``.
The kernel has no backward: the wrapper raises when grad mode is on and
an input needs a gradient (``_build.refuse_autograd``). Training calls it
from ``ops.Rwkv6ScanFunction``'s forward, one launch a group of chunks, its
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
    "rwkv6_scan", Path(__file__).resolve().parent / "csrc" / "rwkv6_scan.cu",
    "rwkv6_scan_fwd", [_P] * 8 + [_I] * 6 + [_P])

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (8, 16, 32, 64, 128)
MIN_COLUMNS = 8        # per-step kernel: v columns per block, 4 lanes each
CHUNKED_HEAD_DIMS = (16, 32, 64, 128)
CHUNK = 16             # steps per chunk of the tensor-core kernel (CK in the .cu)
WARP_COLUMNS = 16      # tensor-core kernel: v columns per warp


def _check(r, k, v, w, u, state) -> None:
    named = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u)]
    if state is not None:
        named.append(("state", state))
    for name, t in named:
        if not t.is_cuda or t.device != r.device:
            raise ValueError(f"rwkv6_scan: {name} is on {t.device}; the "
                             "kernel takes CUDA tensors on one device only")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"rwkv6_scan: {name} must be contiguous and "
                             "16-byte aligned")
    if r.dtype not in DTYPES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_scan: r/k/v must all be float32 or all "
                        f"bfloat16, got {r.dtype}/{k.dtype}/{v.dtype}")
    for name, t in named[3:]:
        if t.dtype != torch.float32:
            raise TypeError(f"rwkv6_scan: {name} must be float32, got {t.dtype}")
    if r.dim() != 4:
        raise ValueError(f"rwkv6_scan: r {tuple(r.shape)} must be [B,S,H,D]")
    B, S, H, D = r.shape
    if k.shape != r.shape or v.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"rwkv6_scan: r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}")
    if tuple(u.shape) != (H, D):
        raise ValueError(f"rwkv6_scan: u {tuple(u.shape)}, expected {(H, D)}")
    if state is not None and tuple(state.shape) != (B, H, D, D):
        raise ValueError(f"rwkv6_scan: state {tuple(state.shape)}, expected "
                         f"{(B, H, D, D)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"rwkv6_scan: head size {D} not in {HEAD_DIMS}")


def plan(dtype: torch.dtype, B: int, S: int, H: int, D: int,
         sms: int) -> dict:
    """The kernel a call of these dtype and shape takes, as the C library
    chooses it (``rwkv6_scan_variant``), and its block split.

    ``kernel`` is "chunked" (bf16, D in ``CHUNKED_HEAD_DIMS``, S >= 1) or
    "per-step"; ``chunk`` the steps of one tile; ``vsplit`` the blocks
    that share one (row, head), each ``columns`` = D / vsplit v columns.
    A chunked block has 8 producer warps, which build each chunk's decays
    and intra-chunk matrix, and a consumer warp for every 16 v columns,
    which runs its products; as the producers' work repeats in every block
    of a head, it splits v only while the grid still fits one block per SM
    (B 1, H 64 on 132 SMs: two blocks a head). The per-step kernel splits v until the grid has two
    blocks per SM, keeping ``MIN_COLUMNS`` columns a block."""
    blocks = B * H
    if dtype == torch.bfloat16 and D in CHUNKED_HEAD_DIMS and S >= 1:
        vsplit = 1
        while blocks * vsplit * 2 <= sms and D // (2 * vsplit) >= WARP_COLUMNS:
            vsplit *= 2
        return {"kernel": "chunked", "chunk": CHUNK, "vsplit": vsplit,
                "columns": D // vsplit}
    vsplit = 1
    while blocks * vsplit < 2 * sms and D // (2 * vsplit) >= MIN_COLUMNS:
        vsplit *= 2
    return {"kernel": "per-step", "chunk": 16, "vsplit": vsplit,
            "columns": D // vsplit}


def variant(r: torch.Tensor) -> str:
    """The kernel ``rwkv6_scan`` launches for r's dtype and shape, as the C
    library chooses it."""
    fn = KERNEL.entry("rwkv6_scan_variant", [_I, _I, _I])
    B, S, H, D = r.shape
    return ("chunked bf16 mma.sync, TMA ring" if fn(DTYPES[r.dtype], D, S)
            else "per-step fp32 CUDA cores")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor,
               state: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r,k,v: [B,S,H,D] fp32|bf16; w: [B,S,H,D] fp32; u: [H,D] fp32;
    state: [B,H,D,D] fp32 or None. Returns (out in r's dtype, state)."""
    refuse_autograd("rwkv6_scan", r, k, v, w, u, state)
    _check(r, k, v, w, u, state)
    B, S, H, D = r.shape
    out = torch.empty_like(r)
    s_out = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return out, s_out
    vsplit = plan(r.dtype, B, S, H, D, sm_count(r.device.index))["vsplit"]
    fn = KERNEL.fn()
    KERNEL.count_launch()
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), None if state is None else state.data_ptr(),
            out.data_ptr(), s_out.data_ptr(), B, S, H, D, DTYPES[r.dtype],
            vsplit, stream_ptr(r))
    KERNEL.check(rc)
    return out, s_out
