"""Dispatching wrapper for flash-decode (twin of
``repro.kernels.flash_decode.ops``): "ref" is the naive oracle, "torch"
the plain online-softmax version, "cuda" the Hopper kernel. ``impl=None``
picks "cuda" for CUDA tensors and "torch" for CPU tensors."""
from __future__ import annotations

from typing import Optional

import torch

from ..flash_attention.ops import decode_mha


def flash_decode(q, k_cache, v_cache, lengths, *, window: int = 0,
                 softcap: float = 0.0, scale: Optional[float] = None,
                 impl: Optional[str] = None) -> torch.Tensor:
    """q: [B,1,H,D]; caches [B,L,KV,D]; lengths [B] -> [B,1,H,D]."""
    if impl == "ref":
        from .ref import flash_decode_ref
        return flash_decode_ref(q, k_cache, v_cache, lengths, window=window,
                                softcap=softcap, scale=scale)
    return decode_mha(q, k_cache, v_cache, lengths, window=window,
                      softcap=softcap, scale=scale, impl=impl)
