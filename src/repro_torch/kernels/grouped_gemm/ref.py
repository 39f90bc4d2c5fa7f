"""Plain PyTorch oracle for the ragged grouped GEMM (MoE expert matmul),
twin of ``repro.kernels.grouped_gemm.ref``.

x: [T, D] tokens sorted by expert; group_sizes: [E]; W: [E, D, F].
out[t] = x[t] @ W[expert_of(t)] for the first sum(group_sizes) rows, and
zero in the rows past them; products in fp32, out in x's dtype.
"""
from __future__ import annotations

import torch


def grouped_gemm_ref(x: torch.Tensor, group_sizes: torch.Tensor,
                     W: torch.Tensor) -> torch.Tensor:
    T, _ = x.shape
    E, _, F = W.shape
    sizes = [int(n) for n in group_sizes.tolist()]
    out = torch.zeros((T, F), dtype=torch.float32, device=x.device)
    start = 0
    for e in range(E):
        n = sizes[e]
        if n == 0:
            continue
        seg = x[start:start + n].float() @ W[e].float()
        out[start:start + n] = seg
        start += n
    return out.to(x.dtype)
