"""Multi-pod dry-run (twin of ``repro.launch.dryrun``): show that every
(arch x shape x mesh) cell runs its step on the production mesh of GPUs
and fits their memory, and report its roofline terms.

No GPU and no second process: the mesh is built over a fake process group
(``torch.testing._internal.distributed.fake_pg``: one rank of a world of
256 or 512 in this process, every collective a no-op that returns a tensor
of the right shape), and parameters, optimizer state, cache and inputs are
fake tensors (``FakeTensorMode``: shapes and dtypes, nothing allocated),
laid out by ``Plan.distribute``. The step (``make_train_step(mesh=...)``,
``make_prefill_step`` or ``make_decode_step``, under
``use_rules(plan.rules)``) is called once under
``roofline.trace_cost.CostMode``. Fake tensors are not CUDA tensors, so
the kernel calls take their plain ``"torch"`` routes, the counterpart of
the reference compiling its XLA fallback; the bytes of those regions are
then replaced by the kernels' boundary traffic
(``analysis.kernel_region_traffic``), as the reference replaces them.

The dry-run owns its process group: it refuses to run while one is up,
and destroys the one it made before it returns.

"Does it fit": the peak of live bytes on rank 0 during the traced step
(inputs included) against ``HBM_BUDGET``. Train cells retry with more
gradient-accumulation microbatches (1, 2, 4, 8, 16) until it fits, as the
reference does.

The record has the reference's keys; these change meaning:

- ``t_lower_s`` is the time to build the inputs and trace the step, and
  ``t_compile_s`` is 0 (nothing is compiled);
- ``hlo_flops`` / ``hlo_bytes`` / ``hlo_bytes_raw`` are the traced counts
  (all GPUs), not HLO's; ``bytes_per_device`` is the peak of live bytes,
  ``arg_bytes_per_device`` the inputs' bytes and
  ``temp_bytes_per_device`` the rest of the peak;
- ``xla_cost_flops`` / ``xla_cost_bytes`` become ``flop_counter_flops``
  (``torch.utils.flop_counter``'s products only, all GPUs) and
  ``dispatch_bytes`` (the traced bytes before the region replacement, all
  GPUs); ``matmul_flops`` (per GPU) is added, the part that should agree
  with the reference's dot FLOPs;
- ``t_collective`` charges each collective at its group's slowest link
  (``analysis``); ``collective_bytes_by_link`` splits the bytes.

Usage (on the CPU, or on the card's machine: the same host run):
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-7b \\
        --shape train_4k [--multi-pod] [--out results.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
import traceback
from typing import Any, Dict, Optional

import torch

from ..configs import cells, get_config, get_shape
from ..models import cache_axes, param_axes
from ..models.config import ModelConfig, ShapeConfig
from ..roofline.analysis import (Roofline, kernel_region_traffic,
                                 model_flops_for)
from ..roofline.trace_cost import trace_cost
from ..sharding.api import AbstractMesh, axis_names, axis_sizes, use_rules
from ..sharding.planner import plan_for
from ..training import (OptimizerConfig, make_decode_step, make_opt_state,
                        make_prefill_step, make_train_step)
from ..training.optimizer import opt_state_axes, tree_map
from .mesh import make_abstract_production_mesh
from .specs import cache_specs, input_specs, param_specs

# NVIDIA H100 SXM5 data sheet: 80 GB of HBM3 a GPU; the reference keeps
# 15.5 of the v5e's 16 GiB (repro/launch/dryrun.py:54), the same share here
HBM_BYTES = 80e9
HBM_BUDGET = HBM_BYTES * 15.5 / 16


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               plan_overrides: Optional[Dict[str, Any]] = None,
               mesh: Optional[AbstractMesh] = None,
               cut: Optional[Dict[str, Any]] = None,
               shape: Optional[ShapeConfig] = None) -> Dict[str, Any]:
    """Trace one cell; return its roofline record. ``mesh``: the mesh's
    axes and sizes (an ``AbstractMesh``; the production mesh by default),
    built here over a fake process group of as many ranks. ``cut``
    replaces config fields (``dataclasses.replace``), ``shape`` the named
    shape (``shape_name`` then only labels the record)."""
    import torch.distributed as dist
    cfg = get_config(arch)
    if cut:
        cfg = dataclasses.replace(cfg, **cut)
    shape = shape or get_shape(shape_name)
    if mesh is None:
        mesh = make_abstract_production_mesh(multi_pod=multi_pod)
    sizes = axis_sizes(mesh)
    chips = 1
    for n in sizes.values():
        chips *= n
    if dist.is_initialized():
        raise RuntimeError("the dry-run builds its mesh over a fake process "
                           "group of its own; a process group is already up")
    _fake_group(chips)
    try:
        return _lower(cfg, arch, shape_name, shape, mesh, chips,
                      dict(plan_overrides or {}))
    finally:
        dist.destroy_process_group()


def _fake_group(world: int) -> None:
    """A fake process group of ``world`` ranks, this process rank 0."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _lower(cfg: ModelConfig, arch: str, shape_name: str, shape: ShapeConfig,
           mesh: AbstractMesh, chips: int, overrides: Dict[str, Any]
           ) -> Dict[str, Any]:
    from torch.distributed.device_mesh import init_device_mesh
    dmesh = init_device_mesh("cpu", tuple(axis_sizes(mesh).values()),
                             mesh_dim_names=axis_names(mesh))
    microbatches = overrides.pop("microbatches", None)
    plan = plan_for(cfg, shape, dmesh, **overrides)
    mb_candidates = ([microbatches] if microbatches else
                     ([1, 2, 4, 8, 16] if shape.kind == "train" else [1]))
    for mb in mb_candidates:
        t0 = time.monotonic()
        cost = _trace(cfg, shape, dmesh, plan, mb)
        t_lower = time.monotonic() - t0
        used_mb = mb
        if cost.peak_bytes <= HBM_BUDGET or mb == mb_candidates[-1]:
            break

    # replace the plain routes' region bytes by the kernels' boundary
    # traffic (see kernel_region_traffic)
    raw_bytes = cost.bytes * chips
    adj_bytes = raw_bytes
    for region, analytic in kernel_region_traffic(cfg, shape).items():
        measured = cost.bytes_by_region.get(region, 0.0) * chips
        if measured > 0:
            adj_bytes = adj_bytes - measured + analytic

    rl = Roofline(
        arch=arch, shape=shape_name,
        mesh="x".join(str(s) for s in axis_sizes(mesh).values()),
        chips=chips, hlo_flops=cost.flops * chips, hlo_bytes=adj_bytes,
        collective_bytes=cost.collective_bytes,
        model_flops=model_flops_for(cfg, shape, shape.kind),
        collectives=cost.coll_bytes_by_op,
        collective_counts={k: int(v) for k, v in cost.coll_counts.items()},
        bytes_per_device=cost.peak_bytes,
        hlo_bytes_raw=raw_bytes,
        bytes_by_region={k: v * chips for k, v in
                         cost.bytes_by_region.items()},
        collective_bytes_by_link=cost.coll_bytes_by_link,
    )
    rec = rl.to_dict()
    rec.update({
        "strategy": plan.strategy, "notes": plan.notes,
        "microbatches": used_mb,
        "t_lower_s": t_lower, "t_compile_s": 0.0,
        "arg_bytes_per_device": cost.arg_bytes,
        "temp_bytes_per_device": cost.peak_bytes - cost.arg_bytes,
        "hbm_budget_bytes": HBM_BUDGET,
        "fits": cost.peak_bytes <= HBM_BUDGET,
        "flop_counter_flops": cost.matmul_flops * chips,
        "dispatch_bytes": raw_bytes,
        "matmul_flops": cost.matmul_flops,
        "status": "ok",
    })
    return rec


def _fake(tree: Any) -> Any:
    """Meta-device specs as tensors of the active fake mode, on the CPU."""
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="cpu"), tree)


def _trace(cfg: ModelConfig, shape: ShapeConfig, dmesh, plan,
           microbatches: int):
    """The ``Cost`` per device of one call of the cell's step on fake
    inputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    fake_mode = FakeTensorMode(allow_non_fake_inputs=True)
    with fake_mode:
        ins = _fake(input_specs(cfg, shape))
        if shape.kind == "train":
            params = _fake(param_specs(cfg))
            axes = param_axes(cfg)
            opt = plan.distribute(make_opt_state(params),
                                  opt_state_axes(axes))
            params = plan.distribute(params, axes)
            with use_rules(plan.rules):
                step = make_train_step(cfg, OptimizerConfig(), mesh=dmesh,
                                       microbatches=microbatches)
                return trace_cost(step, params, opt, ins,
                                  fake_mode=fake_mode)[1]
        else:
            params = plan.distribute(
                _fake(param_specs(cfg, dtype=torch.bfloat16)),
                param_axes(cfg))
            cache = plan.distribute(_fake(cache_specs(cfg, shape)),
                                    cache_axes(cfg))
            tokens = ins.pop("tokens")
            if shape.kind == "prefill":
                step = make_prefill_step(cfg)
            else:
                step = make_decode_step(cfg)
            with use_rules(plan.rules), torch.no_grad():
                return trace_cost(step, params, tokens, cache,
                                  fake_mode=fake_mode, **ins)[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    if args.all:
        todo = [(a, s) for a, s, skip in cells() if not skip]
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all)")
        todo = [(args.arch, args.shape)]

    results = []
    failed = 0
    for arch, shape in todo:
        try:
            rec = lower_cell(arch, shape, multi_pod=args.multi_pod)
            print(f"[ok]   {arch:24s} {shape:12s} "
                  f"bottleneck={rec['bottleneck']:10s} "
                  f"t=({rec['t_compute']:.4f},{rec['t_memory']:.4f},"
                  f"{rec['t_collective']:.4f})s "
                  f"mfu_bound={rec['mfu_bound']:.3f} "
                  f"mem/dev={rec['bytes_per_device']/2**30:.2f}GiB "
                  f"mb={rec['microbatches']} fits={rec['fits']} "
                  f"trace={rec['t_lower_s']:.0f}s", flush=True)
        except Exception as e:
            failed += 1
            rec = {"arch": arch, "shape": shape, "status": "fail",
                   "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()}
            print(f"[FAIL] {arch:24s} {shape:12s} {type(e).__name__}: {e}",
                  flush=True)
        results.append(rec)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
