"""The training cell: a tenant's fine-tuning job, ``make_train_step``'s
step fed seeded batches in a closed loop, as a tenant's WorkUnit body
feeds it (it reads the loss back after every step).

Set-up builds one object, the step with its fp32 master weights and
AdamW state, and drives it from the seed through its first three steps,
on the same call and feed the window uses and on rows that all differ;
from the state those steps leave it takes the numbers the check compares.
The window then runs whole steps until ``seconds`` have passed.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Any, Dict, List, Tuple

import torch

from . import kineto
from .manifest import reference
from .weights import get, leaves, make_leaf, make_weights, per_layer

NS = 1_000_000_000
CHECK_STEPS = 3


def batch_at(config: Dict[str, Any], mix: Dict[str, Any], seed: int,
             step: int, device: torch.device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch from (seed, step): token ids uniform over the
    vocabulary, then the inputs that the configuration's reference module
    adds (``inputs``: image tokens, say)."""
    model = config["model"]
    B, S = int(mix["batch"]), int(mix["seq"])
    gen = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + step) % (2 ** 62))
    out = {"tokens": torch.randint(0, model["vocab"], (B, S), generator=gen,
                                   device=device, dtype=torch.int32)}
    out.update(reference(config).inputs(model, B, gen, device))
    return out


def change_norms(params: Dict[str, Any], config: Dict[str, Any], seed: int
                 ) -> Dict[str, float]:
    """Each leaf's norm of its change from the seed's start, the start
    made again one stacked leaf at a time."""
    out: Dict[str, float] = {}
    for i, leaf in enumerate(leaves(config)):
        now = get(params, leaf[0])
        diff = now.detach().float() - make_leaf(leaf, seed, i, now.device,
                                                torch.float32)
        for name, t in _split(leaf[0], diff):
            out[name] = float(t.double().norm())
        del diff
    return out


def _split(path, t: torch.Tensor):
    """(name, tensor) of a leaf, a stacked one split by layer (the names of
    ``weights.per_layer``)."""
    name = ".".join(path)
    if path[0] == "blocks":
        return [(f"{name}[{layer}]", t[layer]) for layer in range(t.shape[0])]
    return [(name, t)]


def norms(tree: Dict[str, Any], config: Dict[str, Any], scale: float = 1.0
          ) -> Dict[str, float]:
    return {n: float(t.double().norm()) * scale
            for n, t in per_layer(tree, config)}


class TrainCell:
    """One training cell's system under test, set up once."""

    def __init__(self, cell, seed: int, device: torch.device, log=print):
        from repro_torch.models.config import ModelConfig
        from repro_torch.training import (OptimizerConfig, make_opt_state,
                                          make_train_step)
        self.cell, self.mix, self.log = cell, cell.mix, log
        self.config = cell.config
        self.model = cell.config["model"]
        self.seed, self.device = int(seed), device
        self.opt_cfg = dict(self.mix["optimizer"])
        cfg = ModelConfig(**self.model)
        self.params = make_weights(self.config, seed, device, torch.float32)
        self.opt = make_opt_state(self.params)
        self.step_fn = make_train_step(
            cfg, OptimizerConfig(**self.opt_cfg), remat=True,
            microbatches=int(self.mix["microbatches"]))
        self.tokens_per_step = int(self.mix["batch"]) * int(self.mix["seq"])
        self.next_step = 0
        self.losses: List[float] = []
        for i in range(CHECK_STEPS):
            loss, metrics = self.run_step()
            if i == 0:
                gn = float(metrics["grad_norm"])
                scale = min(1.0, self.opt_cfg["clip_norm"] / (gn + 1e-9))
                self.grad1 = norms(self.opt["m"], self.config,
                                   1.0 / ((1 - self.opt_cfg["b1"]) * scale))
        self.change3 = change_norms(self.params, self.config, self.seed)

    def run_step(self) -> Tuple[float, Dict[str, Any]]:
        """One step of the job on the next batch; the loss read back."""
        batch = batch_at(self.config, self.mix, self.seed, self.next_step,
                         self.device)
        self.params, self.opt, metrics = self.step_fn(self.params, self.opt,
                                                      batch)
        loss = float(metrics["loss"])
        self.losses.append(loss)
        self.next_step += 1
        return loss, metrics

    def window(self, seconds: float, trace: bool = False) -> Dict[str, Any]:
        """Whole steps until ``seconds`` have passed; a traced window
        profiles its ``slice_step``-th step."""
        times: List[Tuple[int, int]] = []
        slice_at = int(self.mix.get("slice_step", 1))
        sl = slice_mono = None
        t0 = time.monotonic_ns()
        while True:
            k = len(times)
            if trace and k == slice_at:
                from torch.profiler import (ProfilerActivity, profile,
                                            record_function)
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    with record_function("vcbench.slice"):
                        a = time.monotonic_ns()
                        self.run_step()
                        b = time.monotonic_ns()
                slice_mono = (a, b)
                times.append((a, b))
                sl = (prof, a)
            else:
                a = time.monotonic_ns()
                self.run_step()
                times.append((a, time.monotonic_ns()))
            if times[-1][1] - t0 >= seconds * NS:
                break
        out = {"t0": t0, "t1": times[-1][1], "steps": times,
               "losses": self.losses[CHECK_STEPS:],
               "slice": None, "slice_mono": slice_mono}
        if sl is not None:
            out["slice"] = kineto.profile_slice(
                sl[0], sl[1], [("train_step", *slice_mono)])
        return out

    def free(self) -> None:
        self.params = self.opt = self.step_fn = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_numbers(config: Dict[str, Any], mix: Dict[str, Any],
                      seed: int, device: torch.device,
                      precision: str = "fp32", steps: int = CHECK_STEPS
                      ) -> Dict[str, Any]:
    """The reference's losses, first-gradient norms and change norms over
    the first ``steps`` steps of the seed's job (the same weights and
    batches as the program's), by ``config``'s reference module."""
    from reference.common import AdamW, flat, precise
    precise()
    ref = reference(config).Ref(config["model"], precision)
    params = make_weights(config, seed, device, torch.float32)
    for _, p in flat(params):
        p.requires_grad_(True)
    adam = AdamW(mix["optimizer"], params)
    B, S = int(mix["batch"]), int(mix["seq"])
    weight = B * (S - 1)
    losses, grad1 = [], None
    for i in range(steps):
        batch = batch_at(config, mix, seed, i, device)
        total = 0.0
        for row in range(B):
            ls = ref.row_loss_sum(params, batch["tokens"][row],
                                  **{k: v[row] for k, v in batch.items()
                                     if k != "tokens"})
            (ls / weight).backward()
            total += float(ls.detach())
        losses.append(total / weight)
        grads = [p.grad for _, p in flat(params)]
        if i == 0:
            grad1 = {}
            for (path, _), g in zip(flat(params), grads):
                for name, t in _split(path, g):
                    grad1[name] = float(t.double().norm())
        adam.step(grads)
        for _, p in flat(params):
            p.grad = None
    with torch.no_grad():
        change = change_norms(params, config, seed)
    del params, adam
    gc.collect()
    return {"losses": losses, "grad1": grad1, "change": change}


def loss_gap(prog: List[float], ref: List[float]) -> float:
    return max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
               for a, b in zip(prog, ref))
