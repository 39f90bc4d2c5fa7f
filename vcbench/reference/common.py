"""What every architecture's reference shares: float32 products with TF32
off, the fp8 rounding of the control, the program's padded vocabulary,
the flattening of a weights tree, and AdamW with decoupled weight decay,
global-norm clipping and a linear warm-up into a cosine schedule.

A configuration's reference module (``vcbench/reference/model.py`` and
its contract) imports these from here and re-exports what the harness
asks of it; the harness imports them from here directly.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

FP8_MAX = 448.0


def precise() -> None:
    """float32 products in float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 (a scale per tensor), the gradient
    passed straight through: the control's precision."""
    s = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


def padded_vocab(vocab: int) -> int:
    """The program's padded vocabulary (rows of the table and the head)."""
    unit = 256 if vocab < 8192 else 4096
    return -(-vocab // unit) * unit


def lr_at(opt: Dict[str, float], step: int) -> float:
    """Linear warm-up to ``peak_lr`` over ``warmup_steps``, then cosine
    decay to ``min_lr_ratio`` of it at ``total_steps``."""
    peak, warm = opt["peak_lr"], opt["warmup_steps"]
    if step < warm:
        return peak * step / max(1.0, warm)
    prog = min(max((step - warm) / max(1.0, opt["total_steps"] - warm), 0.0),
               1.0)
    r = opt["min_lr_ratio"]
    return peak * (r + (1 - r) * 0.5 * (1 + math.cos(math.pi * prog)))


def flat(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
         ) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out += flat(v, prefix + (k,))
        else:
            out.append((prefix + (k,), v))
    return out


class AdamW:
    """The optimizer's state and update, float32 throughout. Weight decay
    falls on every leaf of two or more dimensions (the program's rule)."""

    def __init__(self, opt: Dict[str, float], params: Dict[str, Any]):
        self.o = opt
        self.leaves = flat(params)
        self.m = [torch.zeros_like(p) for _, p in self.leaves]
        self.v = [torch.zeros_like(p) for _, p in self.leaves]
        self.t = 0

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> Tuple[float, float]:
        """Update the parameters in place; returns (the gradients' global
        norm before clipping, the clip scale)."""
        o = self.o
        self.t += 1
        norm = math.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
        scale = min(1.0, o["clip_norm"] / (norm + 1e-9))
        lr = lr_at(o, self.t)
        b1c, b2c = 1 - o["b1"] ** self.t, 1 - o["b2"] ** self.t
        for (_, p), g, m, v in zip(self.leaves, grads, self.m, self.v):
            g = g * scale
            m.mul_(o["b1"]).add_((1 - o["b1"]) * g)
            v.mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
            delta = (m / b1c) / (torch.sqrt(v / b2c) + o["eps"])
            if p.ndim >= 2:
                delta = delta + o["weight_decay"] * p
            p.sub_(lr * delta)
        return norm, scale
