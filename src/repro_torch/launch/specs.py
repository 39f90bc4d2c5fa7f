"""Shape-only stand-ins for every model input and state (twin of
``repro.launch.specs``): tensors on the ``meta`` device, which allocate no
memory, in place of the reference's ``ShapeDtypeStruct`` and
``eval_shape``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..models import init_cache, init_params
from ..models.config import ModelConfig, ShapeConfig
from ..training.optimizer import init_opt_state, tree_map

META = torch.device("meta")


def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Batch inputs for one step of the given kind."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind in ("train", "prefill"):
        out: Dict[str, Any] = {"tokens": _empty((B, S), torch.int32)}
        if shape.kind == "train":
            out["mask"] = _empty((B, S), torch.float32)
        if cfg.frontend == "vit_stub":
            out["patches"] = _empty((B, cfg.frontend_tokens,
                                     cfg.frontend_dim), torch.float32)
        elif cfg.frontend == "speech_stub":
            out["frames"] = _empty((B, S, cfg.frontend_dim), torch.float32)
        return out
    # decode: one new token against a seq_len cache
    return {"tokens": _empty((B, 1), torch.int32),
            "lengths": _empty((B,), torch.int32)}


def param_specs(cfg: ModelConfig, dtype: Optional[torch.dtype] = None) -> Any:
    """The parameter tree (fp32 masters, or every floating leaf in
    ``dtype``: serving uses bf16)."""
    tree = init_params(cfg, generator=torch.Generator(),
                       device=META, dtype=torch.float32)
    if dtype is None:
        return tree
    return tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                    tree)


def opt_specs(params_tree: Any) -> Any:
    return init_opt_state(params_tree)


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype: torch.dtype = torch.bfloat16) -> Any:
    return init_cache(cfg, shape.global_batch, shape.seq_len,
                      enc_len=shape.seq_len if cfg.is_encdec else 0,
                      dtype=dtype, device=META)
