"""Dispatching wrapper for the ragged grouped GEMM (twin of
``repro.kernels.grouped_gemm.ops``): the dropless-MoE expert product
``out[t] = x[t] @ W[expert_of(t)]`` over rows sorted by expert.

Implementations:
- "ref":   the per-expert loop of ``ref.py`` (oracle);
- "torch": one fp32 product per group on its segment of rows (the
           reference's "xla" path, ``jax.lax.ragged_dot``); the kernel's
           plain version;
- "cuda":  the hand-written Hopper kernel (``kernel.py``), which reads the
           group sizes on the device and needs no block-aligned copy.

``impl=None`` picks "cuda" for CUDA tensors and "torch" for CPU tensors.
A CUDA tensor never falls back: the kernel launches or raises.

All three give zero rows past ``sum(group_sizes)``, as ``ragged_dot`` and
the reference oracle do (the reference's Pallas path leaves those rows
unwritten), and return x's dtype with fp32 accumulation.
"""
from __future__ import annotations

from typing import Optional

import torch

from .ref import grouped_gemm_ref


def grouped_gemm(x: torch.Tensor, group_sizes: torch.Tensor, W: torch.Tensor,
                 *, block_m: int = 128, impl: Optional[str] = None
                 ) -> torch.Tensor:
    """x: [T, D] sorted by expert; group_sizes: [E] int; W: [E, D, F] ->
    [T, F] in x's dtype. ``block_m`` is the reference's row block; no path
    here pads to it."""
    _check(x, group_sizes, W)
    impl = impl or ("cuda" if x.is_cuda else "torch")
    if impl == "ref":
        return grouped_gemm_ref(x, group_sizes, W)
    if impl == "torch":
        return _grouped_gemm_torch(x, group_sizes, W)
    if impl == "cuda":
        from .kernel import grouped_gemm as grouped_gemm_cuda
        return grouped_gemm_cuda(x, group_sizes, W)
    raise ValueError(f"unknown grouped gemm impl: {impl}")


def _check(x, group_sizes, W) -> None:
    if x.dim() != 2 or W.dim() != 3 or W.shape[1] != x.shape[1]:
        raise ValueError(f"grouped_gemm: x {tuple(x.shape)} must be [T, D] "
                         f"and W {tuple(W.shape)} [E, D, F]")
    if x.dtype != W.dtype:
        raise TypeError(f"grouped_gemm: x is {x.dtype} and W {W.dtype}; "
                        "they must have one dtype")
    if (group_sizes.dim() != 1 or group_sizes.shape[0] != W.shape[0]
            or group_sizes.is_floating_point() or group_sizes.is_complex()):
        raise ValueError(f"grouped_gemm: group_sizes {tuple(group_sizes.shape)} "
                         f"{group_sizes.dtype} must be [E = {W.shape[0]}] "
                         "integers")


def _grouped_gemm_torch(x, group_sizes, W):
    T = x.shape[0]
    F = W.shape[2]
    ends = group_sizes.long().clamp(min=0).cumsum(0).clamp(max=T).tolist()
    out = torch.zeros((T, F), dtype=x.dtype, device=x.device)
    start = 0
    for e, end in enumerate(ends):
        if end > start:
            out[start:end] = (x[start:end].float() @ W[e].float()).to(x.dtype)
        start = max(start, end)
    return out
