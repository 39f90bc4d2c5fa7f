"""Oracle for single-token decode attention (delegates to the naive mha;
twin of ``repro.kernels.flash_decode.ref``)."""
from __future__ import annotations

import torch

from ..flash_attention.ref import mha_ref


def flash_decode_ref(q, k_cache, v_cache, lengths, *, window: int = 0,
                     softcap: float = 0.0, scale=None) -> torch.Tensor:
    """q: [B,1,H,D]; caches [B,L,KV,D]; lengths [B]. Returns [B,1,H,D]."""
    outs = []
    for b, t in enumerate(lengths.tolist()):
        outs.append(mha_ref(q[b:b + 1], k_cache[b:b + 1, :t],
                            v_cache[b:b + 1, :t], causal=True, window=window,
                            softcap=softcap, scale=scale, q_offset=t - 1))
    return torch.cat(outs, dim=0)
