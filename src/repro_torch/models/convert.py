"""Weights from the JAX package: ``params_from_jax`` maps the reference's
parameter tree, its leaves already turned into numpy arrays, onto the
port's parameters (the same tree of tensors).

Layout: blocks stacked on the leading ``n_blocks`` axis with sub-layers
``sub{i}``; dense weights ``w`` [in, out] with an optional ``b``;
``embed.table``, ``final_norm`` and ``lm_head`` (absent when
``tie_embeddings``). A leaf is stored in ``compute_dtype`` only where the
reference casts it to the compute dtype at every use, and in fp32
everywhere else (``Param.compute`` in ``transformer.param_specs``), so this
equals the reference's numerics while halving the footprint of the
matrices in bf16.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .config import ModelConfig
from .layers import Param
from .transformer import param_specs


def params_from_jax(np_tree: Dict[str, Any], cfg: ModelConfig, *,
                    device: DeviceLike = None,
                    compute_dtype: torch.dtype = torch.bfloat16
                    ) -> Dict[str, Any]:
    spec = param_specs(cfg)
    device = resolve_device(device)
    table = np.shape(np_tree.get("embed", {}).get("table"))
    if tuple(table) != (cfg.padded_vocab, cfg.d_model):
        raise ValueError(f"{cfg.name}: embed table {table}, expected "
                         f"{(cfg.padded_vocab, cfg.d_model)}")

    def conv(tree: Any, p: Any, path: str) -> Any:
        if isinstance(p, Param):
            arr = np.array(tree, dtype=np.float32)   # a writable copy
            return torch.from_numpy(arr).to(device=device,
                                            dtype=p.dtype(compute_dtype))
        if not isinstance(tree, dict) or set(tree) != set(p):
            have = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{cfg.name}: parameter tree at '{path}' has "
                             f"{have}, expected {sorted(p)}")
        return {k: conv(tree[k], p[k], f"{path}/{k}") for k in tree}

    return conv(np_tree, spec, "")
