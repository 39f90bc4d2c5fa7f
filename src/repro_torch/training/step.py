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
and are split into microbatches with its tokens.

With ``mesh`` (a ``DeviceMesh``) the step runs under the sharding rules of
a plan on that mesh (``use_rules(plan.rules)`` around the call, or around
``make_train_step``), on DTensor parameters and optimizer state
(``Plan.distribute``); the batch is the whole batch on every rank, plain
or a DTensor, and each rank keeps its shard where the model lays the
activations out. The gradients come out laid out as their parameters (the
sum over "data" is DTensor's reduction of the ``Partial`` gradients), and
AdamW updates the shards in place. With ``grad_compress_pod`` and a "pod"
mesh axis, each pod computes the gradient of its own part of the batch on
its own (data, model) sub-mesh and the pods average it in int8 with error
feedback (``grad_compress.compressed_pod_mean``); ``opt_state`` then
carries the residual tree "ef" (``make_opt_state(grad_compress_pod=True)``),
whose values differ between pods as the reference's do.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication

from ..models import decode_step as model_decode_step
from ..models import loss_fn as model_loss_fn
from ..models import prefill as model_prefill
from ..models.config import ModelConfig
from ..models.transformer import check_supported
from ..sharding import collectives as col
from ..sharding.api import ShardingRules, active_rules, use_rules
from .grad_compress import compressed_pod_mean, init_error_state
from .optimizer import (OptimizerConfig, adamw_update, init_opt_state,
                        tree_leaves, tree_map)


def _device_batch(batch: Dict[str, Any], device: torch.device
                  ) -> Dict[str, torch.Tensor]:
    """The batch's arrays as tensors on ``device`` (tokens stay int32); a
    DTensor as its whole tensor."""
    return {k: v.full_tensor() if isinstance(v, DTensor)
            else torch.as_tensor(v).to(device) for k, v in batch.items()}


def _replicated(t: torch.Tensor) -> torch.Tensor:
    """A DTensor laid out replicated (a plain tensor as it is)."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, [Replicate()] * t.device_mesh.ndim)


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
    with torch.enable_grad(), _local_ok(work):
        for mb in parts:
            loss, aux = model_loss_fn(tree_map(_to_compute, work), mb, cfg,
                                      remat=remat, impl=impl)
            loss = _replicated(loss)
            loss.backward()      # fp32 grads, summed in place over parts
            loss_sum = loss_sum + _replicated(aux["loss_sum"]).detach()
            weight = weight + aux["weight"].detach()
    grads = tree_map(lambda p: p.grad, work)
    if isinstance(tree_leaves(work)[0], DTensor):   # laid out as the params
        grads = _laid_out(grads, work)
    if microbatches > 1:
        for g in tree_leaves(grads):
            g.div_(microbatches)
        loss = loss_sum / torch.clamp(weight, min=1.0)
    return loss.detach(), {"loss_sum": loss_sum, "weight": weight}, grads


def _laid_out(grads: Any, like: Any) -> Any:
    if isinstance(grads, dict):
        return {k: _laid_out(v, like[k]) for k, v in grads.items()}
    return grads.redistribute(like.device_mesh, like.placements)


@contextlib.contextmanager
def _sharded(mesh, made_rules: Optional[ShardingRules]
             ) -> Iterator[Optional[ShardingRules]]:
    """The rules a step on ``mesh`` runs under (the active ones, else those
    active when the step was made), with plain tensors read as replicated
    DTensors; nothing without a mesh."""
    if mesh is None:
        yield None
        return
    rules = active_rules() or made_rules
    if rules is None or rules.mesh is not mesh:
        raise ValueError("a step on a mesh runs under the sharding rules of "
                         "a plan on that mesh: use_rules(plan_for(cfg, shape, "
                         "mesh).rules)")
    with use_rules(rules), implicit_replication():
        yield rules


def _without_pod(binding):
    axes = (binding,) if isinstance(binding, str) else tuple(binding or ())
    axes = tuple(a for a in axes if a != "pod")
    return None if not axes else axes[0] if len(axes) == 1 else axes


def _pod_local(tree: Any, sub, pod_dim: int) -> Any:
    """DTensors replicated over the pod dim as DTensors of ``sub``."""
    if isinstance(tree, dict):
        return {k: _pod_local(v, sub, pod_dim) for k, v in tree.items()}
    if not tree.placements[pod_dim].is_replicate():
        raise ValueError("grad_compress_pod needs parameters replicated over "
                         "the pod axis")
    pl = [p for i, p in enumerate(tree.placements) if i != pod_dim]
    return DTensor.from_local(tree.to_local(), sub, pl, run_check=False)


def _on_mesh(tree: Any, mesh, pod_dim: int) -> Any:
    """Pod-local DTensors of a sub-mesh back on ``mesh``, nominally
    replicated over the pod dim (each pod keeps its own values)."""
    if isinstance(tree, dict):
        return {k: _on_mesh(v, mesh, pod_dim) for k, v in tree.items()}
    pl = list(tree.placements)
    pl.insert(pod_dim, Replicate())
    return DTensor.from_local(tree.to_local(), mesh, pl, run_check=False)


def pod_local_grads(cfg: ModelConfig, rules: ShardingRules, params: Any,
                    batch: Dict[str, Any], *, remat: bool = True,
                    microbatches: int = 1, impl: Optional[str] = None
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], Any]:
    """``compute_grads`` of this rank's pod: its part of the batch (rows
    split over "pod" in order) on the pod's own sub-mesh of the other axes,
    under the rules with "pod" unbound. The gradients come back on the
    whole mesh (see ``_on_mesh``); loss and aux are the pod's."""
    mesh = rules.mesh
    names = tuple(mesh.mesh_dim_names)
    pod_dim = names.index("pod")
    sub = mesh[tuple(n for n in names if n != "pod")]
    sub_rules = ShardingRules(sub, {k: _without_pod(v)
                                    for k, v in rules.bindings.items()})
    npod, pod = mesh.size(pod_dim), mesh.get_local_rank("pod")
    batch = _device_batch(batch, tree_leaves(params)[0].device)
    rows = batch["tokens"].shape[0] // npod
    part = {k: v[pod * rows:(pod + 1) * rows] for k, v in batch.items()}
    with use_rules(sub_rules):
        loss, aux, grads = compute_grads(
            cfg, _pod_local(params, sub, pod_dim), part, remat=remat,
            microbatches=microbatches, impl=impl)
    return loss, aux, _on_mesh(grads, mesh, pod_dim)


def _pod_mean(t: torch.Tensor, mesh) -> torch.Tensor:
    """A pod's scalar (a replicated DTensor of its sub-mesh) averaged over
    the pods, as a plain tensor."""
    local = t.to_local() if isinstance(t, DTensor) else t
    return col.all_reduce(local, "sum", mesh, "pod") / mesh.size(
        mesh.mesh_dim_names.index("pod"))


def make_train_step(cfg: ModelConfig, opt_cfg: OptimizerConfig, *,
                    mesh: Any = None, grad_compress_pod: bool = False,
                    remat: bool = True, microbatches: int = 1,
                    impl: Optional[str] = None) -> Callable:
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics) with metrics "lr", "grad_norm", "step", "loss" and "tokens"
    (0-d tensors on the parameters' device; DTensors on a mesh). ``impl``
    picks the attention path (None: the kernel for CUDA tensors, the plain
    version on the CPU). ``grad_compress_pod`` without a "pod" mesh axis
    is ignored, as in the reference."""
    check_supported(cfg)
    use_compress = (grad_compress_pod and mesh is not None
                    and "pod" in mesh.mesh_dim_names)
    made_rules = active_rules()

    def train_step(params, opt_state, batch):
        extra: Dict[str, Any] = {}
        with _sharded(mesh, made_rules) as rules:
            if use_compress:
                loss, aux, grads = pod_local_grads(
                    cfg, rules, params, batch, remat=remat,
                    microbatches=microbatches, impl=impl)
                grads, extra["ef"] = compressed_pod_mean(
                    grads, opt_state["ef"], mesh)
                loss = _pod_mean(loss, mesh)
                aux = {k: _pod_mean(v, mesh) for k, v in aux.items()}
            else:
                loss, aux, grads = compute_grads(
                    cfg, params, batch, remat=remat,
                    microbatches=microbatches, impl=impl)
            params, opt_state, metrics = adamw_update(opt_cfg, params, grads,
                                                      opt_state)
        opt_state.update(extra)
        metrics = dict(metrics)
        metrics["loss"] = loss
        metrics["tokens"] = aux["weight"]
        return params, opt_state, metrics

    return train_step


def make_opt_state(params: Any, *, grad_compress_pod: bool = False
                   ) -> Dict[str, Any]:
    """AdamW state; with ``grad_compress_pod`` also the int8 compression's
    fp32 residual "ef", zeros like the params."""
    state = init_opt_state(params)
    if grad_compress_pod:
        state["ef"] = init_error_state(params)
    return state


def _local_ok(params: Any):
    """Plain tensors read as replicated when the params are DTensors."""
    if isinstance(tree_leaves(params)[0], DTensor):
        return implicit_replication()
    return contextlib.nullcontext()


def make_prefill_step(cfg: ModelConfig, *, impl: Optional[str] = None
                      ) -> Callable:
    """prefill_step(params, tokens, cache, frames=None, patches=None,
    lengths=None) -> (logits, cache, lengths), ``lengths`` the rows' true
    prompt lengths as ``models.prefill`` takes them; under sharding rules
    with DTensor params and cache (``Plan.distribute``), sharded as the
    plan lays them out."""
    def prefill_step(params, tokens, cache, frames=None, patches=None,
                     lengths=None):
        with _local_ok(params):
            return model_prefill(params, cfg, tokens, cache, lengths=lengths,
                                 frames=frames, patches=patches, impl=impl)
    return prefill_step


def make_decode_step(cfg: ModelConfig, *, impl: Optional[str] = None
                     ) -> Callable:
    """serve_step(params, tokens, cache, lengths) -> (logits, cache,
    lengths + 1); sharded under rules as ``make_prefill_step``."""
    def serve_step(params, tokens, cache, lengths):
        with _local_ok(params):
            return model_decode_step(params, cfg, tokens, cache, lengths,
                                     impl=impl)
    return serve_step
