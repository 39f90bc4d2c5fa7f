"""Sharding planner (twin of ``repro.sharding.planner``): picks a legal,
efficient layout per (arch, shape, mesh).

Strategies (auto-selected, overridable):

- **tp_heads**: Megatron-style tensor parallelism. Attention heads are
  sharded over "model" (KV heads too when divisible, else replicated),
  FFN/vocab/experts over "model", and the residual stream is
  sequence-sharded over "model" between blocks (Megatron sequence
  parallelism: all-gather at block entry, reduce-scatter at exit).
- **context**: the fallback when n_heads % model != 0 (qwen2-7b: 28 heads).
  q is sequence-sharded over "model" and K/V are all-gathered; everything
  else as tp_heads.
- **decode**: serving steps. S = 1 leaves no sequence to shard, so the KV
  cache is sharded along its *sequence* dim over "model" and decode
  attention combines per-slice partial softmaxes (max-rescaled sums over
  the axis), for every head count.

Training defaults to FSDP over "data" for params and optimizer state (the
"embed" param axis additionally sharded over data).

``Plan.distribute`` turns a tree of the port's tensors (parameters,
optimizer state, cache) into DTensors on a ``DeviceMesh`` by their logical
axes, the twin of ``jax.device_put`` with ``tree_sharding``; the placement
trees of ``train_shardings`` and ``serve_shardings`` are what it places by.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from torch.distributed.tensor import DTensor, distribute_tensor

from ..models import cache_axes as model_cache_axes
from ..models import param_axes as model_param_axes
from ..models.config import ModelConfig, ShapeConfig
from ..training.optimizer import opt_state_axes
from .api import ShardingRules, axis_sizes


def _map_axes(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map_axes(fn, v) for k, v in tree.items()}
    return fn(tree)


@dataclass
class Plan:
    rules: ShardingRules
    strategy: str
    notes: List[str] = field(default_factory=list)

    # -- placement trees -----------------------------------------------------

    def tree_placements(self, axes_tree: Any) -> Any:
        return _map_axes(self.rules.placements, axes_tree)

    def named(self, *names: Optional[str]):
        return self.rules.placements(names)

    def distribute(self, tree: Any, axes_tree: Any) -> Any:
        """Every tensor of ``tree`` as a DTensor on the plan's mesh, laid
        out by its logical axes in ``axes_tree`` (same structure; a 0-d
        tensor has axes ``()``). Each rank passes the whole tensor, the
        same on every rank, and keeps its shard. The mesh's device type
        decides where the shards live."""
        mesh = self.rules.mesh
        if isinstance(tree, dict):
            return {k: self.distribute(v, axes_tree[k]) for k, v in tree.items()}
        if isinstance(tree, DTensor):
            return tree.redistribute(mesh, self.rules.placements(axes_tree))
        t = tree.to(mesh.device_type)
        return distribute_tensor(t, mesh, self.rules.placements(axes_tree))


def _divides(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _batch_axes(mesh, global_batch: int) -> Tuple[str, ...]:
    """Greedy maximal prefix of (pod, data) whose product divides the batch."""
    sizes = axis_sizes(mesh)
    axes: Tuple[str, ...] = ()
    prod = 1
    for a in ("pod", "data"):
        if a in sizes and _divides(global_batch, prod * sizes[a]):
            axes += (a,)
            prod *= sizes[a]
    return axes


def plan_for(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
             fsdp: Optional[bool] = None,
             strategy: Optional[str] = None,
             seq_shard: bool = True) -> Plan:
    sizes = axis_sizes(mesh)
    model = sizes.get("model", 1)
    data_axes = _batch_axes(mesh, shape.global_batch)
    heads_div = _divides(cfg.n_heads, model)
    kv_div = _divides(cfg.n_kv_heads, model)
    mode = shape.kind                    # train | prefill | decode
    if fsdp is None:
        fsdp = mode == "train"
    notes: List[str] = []

    if strategy is None:
        if mode == "decode":
            strategy = "decode"
        elif heads_div:
            strategy = "tp_heads"
        else:
            strategy = "context"
            notes.append(
                f"{cfg.name}: {cfg.n_heads} heads % model={model} != 0 -> "
                f"context-parallel attention (KV all-gathered)")

    seq_ok = seq_shard and _divides(shape.seq_len, model) and mode != "decode"

    bindings: Dict[str, Any] = {
        # params
        "vocab": "model",
        "mlp": "model",
        "expert": "model" if _divides(cfg.n_experts, model) or not cfg.is_moe
        else None,
        "inner": "model" if _divides(cfg.mamba_d_inner, model) else None,
        "heads_flat": "model" if heads_div and strategy != "decode" else None,
        "kv_flat": "model" if heads_div and kv_div and strategy != "decode"
        else None,
        "embed": ("data" if fsdp and "data" in sizes else
                  ("model" if mode == "decode" else None)),
        "layers": None,
        # activations
        "batch": data_axes if data_axes else None,
        "seq": "model" if seq_ok else None,
        "act_seq": None,
        "kv_seq": None,
        "attn_seq": "model" if strategy == "context" and seq_ok else None,
        "heads": "model" if heads_div and strategy == "tp_heads" else None,
        "kv_heads": "model" if heads_div and kv_div and strategy == "tp_heads"
        else None,
        "cache_seq": "model" if mode in ("prefill", "decode") else None,
        # moe dispatch token sharding
        "moe_tokens": (data_axes + ("model",)) if seq_ok else
        (data_axes if data_axes else None),
    }
    if cfg.is_moe and not _divides(cfg.n_experts, model):
        notes.append(f"{cfg.name}: {cfg.n_experts} experts % model={model} "
                     f"!= 0 -> experts replicated")
    if not data_axes:
        notes.append(f"global_batch={shape.global_batch} not divisible by "
                     f"data axes -> batch replicated")
    if mode == "decode":
        notes.append("decode: KV-cache sequence-sharded over model + "
                     "flash-decode partial-softmax combine; weights "
                     "row-parallel over model (embed dim), nothing "
                     "replicated")

    rules = ShardingRules(mesh, bindings)
    return Plan(rules=rules, strategy=strategy, notes=notes)


# ------------------------------------------------------------- step layouts

def train_shardings(plan: Plan, cfg: ModelConfig) -> Dict[str, Any]:
    """Placement trees of a train step: "params", "opt" (m/v mirror the
    params, "step" replicated), "batch" and "replicated"."""
    axes = model_param_axes(cfg)
    batch = {"tokens": plan.named("batch", "seq"),
             "mask": plan.named("batch", "seq")}
    if cfg.frontend == "vit_stub":
        batch["patches"] = plan.named("batch", None, None)
    elif cfg.frontend == "speech_stub":
        batch["frames"] = plan.named("batch", "seq", None)
    return {"params": plan.tree_placements(axes),
            "opt": plan.tree_placements(opt_state_axes(axes)),
            "batch": batch, "replicated": plan.named()}


def serve_shardings(plan: Plan, cfg: ModelConfig) -> Dict[str, Any]:
    """Placement trees of the serving steps: "params", "cache" (leading
    dim "layers"), "tokens", "lengths", "frames", "patches", "replicated"."""
    return {"params": plan.tree_placements(model_param_axes(cfg)),
            "cache": plan.tree_placements(model_cache_axes(cfg)),
            "tokens": plan.named("batch", None),
            "lengths": plan.named("batch"),
            "frames": plan.named("batch", "seq", None),
            "patches": plan.named("batch", None, None),
            "replicated": plan.named()}

