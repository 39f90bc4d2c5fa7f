"""AdamW with decoupled weight decay, global-norm clipping and a warmup +
cosine schedule (twin of ``repro.training.optimizer``), on the port's trees
of tensors (nested dicts, the parameter tree of ``models.init_params``).

The state is ``{"step": 0-d int32, "m": fp32 tree, "v": fp32 tree}`` as in
the reference, and every scalar of the update is an fp32 tensor on the
parameters' device, as the reference computes it (the bias corrections
``1 - b ** step`` included), so a step never reads a value back to the
host. Unlike the reference, which returns new trees, ``adamw_update``
updates the parameters, ``m`` and ``v`` in place (under ``torch.no_grad``)
and returns the same objects.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_ratio: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    """``fn`` over the leaves of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The leaves of a tree of nested dicts, keys in sorted order (JAX's
    flattening order)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def lr_schedule(cfg: OptimizerConfig, step: Any) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * peak, in fp32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(1.0, cfg.warmup_steps)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(1.0, cfg.total_steps - cfg.warmup_steps),
                       0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cfg.peak_lr * cos)


def init_opt_state(params: Any) -> Dict[str, Any]:
    """{"step": 0, "m": zeros, "v": zeros}; for DTensor params the moments
    are laid out as their params and the step is replicated."""
    def zeros(p):
        if isinstance(p, DTensor):
            return torch.zeros_like(p, dtype=torch.float32)
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    leaf = tree_leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=leaf.device)
    if isinstance(leaf, DTensor):
        step = DTensor.from_local(step, leaf.device_mesh,
                                  [Replicate()] * leaf.device_mesh.ndim)
    return {"step": step, "m": tree_map(zeros, params),
            "v": tree_map(zeros, params)}


def opt_state_axes(axes: Any) -> Dict[str, Any]:
    """Logical axes for the optimizer state (m/v mirror the params)."""
    return {"step": (), "m": axes, "v": axes}


def global_norm(tree: Any) -> torch.Tensor:
    return torch.sqrt(torch.stack(
        [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]).sum())


def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale, tree), norm


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / (norm + 1e-9), max=1.0)


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Any, grads: Any,
                 state: Dict[str, Any]
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step with the reference's arithmetic. Weight decay applies
    where ``p.ndim >= 2``, as in the reference, which with the blocks
    stacked on ``n_blocks`` includes the stacked norm scales and biases.
    ``params``, ``state["m"]``, ``state["v"]`` and ``state["step"]`` are
    updated in place; the gradients are left as they are (the clip scale
    is applied leaf by leaf)."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    norm = global_norm(grads)
    scale = _clip_scale(norm, cfg.clip_norm)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                     device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                     device=stepf.device), stepf)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": norm, "step": step}
