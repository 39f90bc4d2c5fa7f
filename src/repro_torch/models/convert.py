"""Weights from the JAX package: ``params_from_jax`` maps the reference's
parameter tree, its leaves already turned into numpy arrays, onto the
port's parameters (the same tree of tensors).

Layout: blocks stacked on the leading ``n_blocks`` axis with sub-layers
``sub{i}``; dense weights ``w`` [in, out] with an optional ``b``;
``embed.table``, ``final_norm`` and ``lm_head`` (absent when
``tie_embeddings``). Matrices (``w``, ``table``) are stored in
``compute_dtype`` and everything else in fp32. Every use casts to the
compute dtype first, as the reference does, so this equals its numerics
while halving the footprint in bf16.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from .transformer import check_supported

MATRIX_LEAVES = ("w", "table")


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig, *,
                    device: DeviceLike = None,
                    compute_dtype: torch.dtype = torch.bfloat16
                    ) -> Dict[str, Any]:
    check_supported(cfg)
    device = resolve_device(device)
    expected = {"embed", "final_norm", "blocks"}
    if not cfg.tie_embeddings:
        expected.add("lm_head")
    if set(np_tree) != expected:
        raise ValueError(f"{cfg.name}: parameter tree has {sorted(np_tree)}, "
                         f"expected {sorted(expected)}")
    table = np.shape(np_tree["embed"]["table"])
    if tuple(table) != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"{cfg.name}: embed table {table}, expected "
                         f"{(cfg.padded_vocab, cfg.d_model)}")

    def conv(tree: Any, name: str) -> Any:
        if isinstance(tree, dict):
            return {k: conv(v, k) for k, v in tree.items()}
        arr = np.array(tree, dtype=np.float32)   # a writable copy
        dtype = compute_dtype if name in MATRIX_LEAVES else torch.float32
        return torch.from_numpy(arr).to(device=device, dtype=dtype)

    return conv(np_tree, "")
