"""Train/serve step factories (twin of ``repro.training.step``).

``make_train_step`` returns ``train_step(params, opt_state, batch) ->
(params, opt_state, metrics)``: a bf16-compute forward with remat per block,
the chunked cross-entropy, gradients to the fp32 masters, AdamW (fp32
moments), global-norm clip, warmup + cosine LR. The parameters and the
optimizer state are updated in place (the returned trees are the given
ones). Batches may be numpy: the step moves them to the parameters'
device.

Every model of the registry trains: attention ("g", "l"; the encoder's
and the cross-attention too) through ``MhaFunction``, the recurrent layers
("m", "r") through the scans' ``MambaScanFunction`` and
``Rwkv6ScanFunction``; a batch's "frames" or "patches" reach ``loss_fn``
and are split into microbatches with its tokens. Single device only: a
mesh and the cross-pod int8 gradient compression are multi-GPU (ROADMAP
§1) and raise ``NotImplementedError``.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..models import decode_step as model_decode_step
from ..models import loss_fn as model_loss_fn
from ..models import prefill as model_prefill
from ..models.config import ModelConfig
from ..models.transformer import check_supported
from .optimizer import (OptimizerConfig, adamw_update, init_opt_state,
                        tree_leaves, tree_map)


def _device_batch(batch: Dict[str, Any], device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device`` (tokens stay int32)."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def _to_compute(p: torch.Tensor) -> torch.Tensor:
    """fp32 masters to bf16 before use (the reference casts every fp32
    leaf, norm scales included); the gradient flows back through the
    cast."""
    return p.to(torch.bfloat16) if p.dtype == torch.float32 else p


def compute_grads(cfg: ModelConfig, params: Any, batch: Dict[str, Any], *,
                  remat: bool = True, microbatches: int = 1,
                  impl: Optional[str] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """(loss, {"loss_sum", "weight"}, grads) of ``loss_fn`` on the bf16
    copies of ``params``, the gradients fp32 like the masters. With
    ``microbatches`` > 1 the batch is split along its first axis, the
    gradients are summed in fp32 and divided by ``microbatches``, and loss
    = loss_sum / max(weight, 1) over all of them."""
    check_supported(cfg)
    device = tree_leaves(params)[0].device
    batch = _device_batch(batch, device)
    work = tree_map(lambda p: p.detach().requires_grad_(True), params)
    if microbatches <= 1:
        parts = [batch]
    else:
        B = batch["tokens"].shape[0]
        if B % microbatches:
            raise ValueError(f"batch {B} is not a multiple of "
                             f"{microbatches} microbatches")
        parts = [{k: v.reshape((microbatches, B // microbatches)
                               + tuple(v.shape[1:]))[i]
                  for k, v in batch.items()} for i in range(microbatches)]
    loss_sum = weight = 0.0
    with torch.enable_grad():
        for mb in parts:
            loss, aux = model_loss_fn(tree_map(_to_compute, work), mb, cfg,
                                      remat=remat, impl=impl)
            loss.backward()      # fp32 grads, summed in place over parts
            loss_sum = loss_sum + aux["loss_sum"].detach()
            weight = weight + aux["weight"].detach()
    grads = tree_map(lambda p: p.grad, work)
    if microbatches > 1:
        for g in tree_leaves(grads):
            g.div_(microbatches)
        loss = loss_sum / torch.clamp(weight, min=1.0)
    return loss.detach(), {"loss_sum": loss_sum, "weight": weight}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    mesh: Any = None, grad_compress_pod: bool = False,
                    remat: bool = True, microbatches: int = 1,
                    impl: Optional[str] = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) with metrics "lr", "grad_norm", "step", "loss" and "tokens"
    (0-d tensors on the parameters' device). ``impl`` picks the attention
    path (None: the kernel for CUDA tensors, the plain version on the
    CPU)."""
    if mesh is not None or grad_compress_pod:
        raise NotImplementedError(
            "a mesh and cross-pod gradient compression are multi-GPU, not "
            "ported yet (ROADMAP §1 item 5)")
    check_supported(cfg)

    def train_step(params, opt_state, batch):
        loss, aux, grads = compute_grads(cfg, params, batch, remat=remat,
                                         microbatches=microbatches, impl=impl)
        params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                  opt_state)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["tokens"] = aux["weight"]
        return params, opt_state, metrics

    return train_step


def make_opt_state(params: Any, *, grad_compress_pod: bool = False
                   ) -> Dict[str, Any]:
    if grad_compress_pod:
        raise NotImplementedError(
            "cross-pod gradient compression is multi-GPU, not ported yet "
            "(ROADMAP §1 item 5)")
    return init_opt_state(params)


def make_prefill_step(cfg: ModelConfig, *, impl: Optional[str] = None
                      ) -> Callable:
    def prefill_step(params, tokens, cache, frames=None, patches=None):
        return model_prefill(params, cfg, tokens, cache, frames=frames,
                             patches=patches, impl=impl)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, impl: Optional[str] = None
                     ) -> Callable:
    def serve_step(params, tokens, cache, lengths):
        return model_decode_step(params, cfg, tokens, cache, lengths,
                                 impl=impl)
    return serve_step
