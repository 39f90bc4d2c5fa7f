"""End-to-end driver of the PyTorch port: a tenant trains a model THROUGH
the control plane (twin of ``examples/train_tenant_job.py``).

The tenant submits training WorkUnits (one per bundle of steps) into its
dedicated control plane; the syncer populates the super cluster; the
scheduler binds each unit to a host; the node agent's ``CallableProvider``
runs real train steps of ``repro_torch`` on the card, with a checkpoint
after each unit. Default is a CPU-sized qwen2-style model; --preset 100m
gives the reference's ~100M-parameter config for real hardware. Runs on
the card unless ``--device cpu``.

    PYTHONPATH=src python examples/train_tenant_job_torch.py --units 5 \
        --steps-per-unit 20 --device cpu
"""
import argparse
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, reduced
from repro_torch.core import CallableProvider, VirtualClusterFramework
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.training import (OptimizerConfig, make_opt_state,
                                  make_train_step)
from repro_torch.training.optimizer import tree_leaves


def build_model(preset: str):
    if preset == "100m":
        cfg = ModelConfig(name="demo-100m", family="dense", n_layers=12,
                          d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
                          d_ff=2048, vocab=32768)
        shape = ShapeConfig("demo", 512, 8, "train")
    else:
        cfg = reduced(get_config("qwen2-7b"), d_model=128, n_layers=4,
                      vocab=2048, d_ff=256)
        shape = ShapeConfig("demo", 128, 8, "train")
    return cfg, shape


def run(preset: str = "tiny", units: int = 5, steps_per_unit: int = 20,
        ckpt_dir: str = "", device=None, log=print):
    """Train ``units`` bundles of ``steps_per_unit`` steps through a live
    ``VirtualClusterFramework``. Returns a dict: "cfg", "state" (params,
    opt state, losses), "mgr" (its checkpoints) and "units" (one record a
    unit: name, phase, loss, seconds from submission to Ready)."""
    device = resolve_device(device)
    cfg, shape = build_model(preset)
    gen = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, generator=gen, device=device,
                         dtype=torch.float32)
    n = sum(x.numel() for x in tree_leaves(params))
    log(f"model {cfg.name}: {n/1e6:.1f}M params, "
        f"{shape.tokens} tokens/step on {device}")
    step_fn = make_train_step(
        cfg, OptimizerConfig(peak_lr=1e-3, warmup_steps=10,
                             total_steps=units * steps_per_unit))
    state = {"params": params, "opt": make_opt_state(params), "losses": []}
    data = SyntheticTokens(cfg, shape, DataConfig(seed=0))
    mgr = CheckpointManager(
        ckpt_dir or os.path.join(tempfile.gettempdir(), "vc-train-demo-torch"),
        keep=2)

    def run_unit(unit):
        """Executed by the node agent on whichever host the unit lands."""
        base = unit.spec.payload["base_step"]
        for s in range(steps_per_unit):
            batch = data.batch_at(base + s)
            state["params"], state["opt"], metrics = step_fn(
                state["params"], state["opt"], batch)
            state["losses"].append(float(metrics["loss"]))
        mgr.save(base + steps_per_unit, (state["params"], state["opt"]))
        return state["losses"][-1]

    records = []
    fw = VirtualClusterFramework(
        num_nodes=2, scan_interval=0.0, heartbeat_interval=3600,
        provider_factory=lambda node: CallableProvider(run_unit))
    with fw:
        tenant = fw.add_tenant("ml-team")
        t0 = time.monotonic()
        for i in range(units):
            name = f"step-bundle-{i:03d}"
            unit = fw.make_unit(name, "jobs", chips=1, arch=cfg.name,
                                payload={"base_step": i * steps_per_unit})
            t_sub = time.monotonic()
            fw.submit(tenant, unit)
            done = fw.wait_ready(tenant, "jobs", name, timeout=600)
            records.append({"unit": name, "phase": done.status.phase,
                            "loss": state["losses"][-1],
                            "submit_to_ready_s": time.monotonic() - t_sub})
            log(f"unit {i}: loss={state['losses'][-1]:.4f} "
                f"({(i+1)*steps_per_unit} steps, "
                f"{time.monotonic()-t0:.1f}s)")
    mgr.wait()
    return {"cfg": cfg, "state": state, "mgr": mgr, "units": records}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m"])
    ap.add_argument("--units", type=int, default=5)
    ap.add_argument("--steps-per-unit", type=int, default=20)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args()
    out = run(args.preset, args.units, args.steps_per_unit, args.ckpt_dir,
              args.device, log=lambda m: print(m, flush=True))
    losses = out["state"]["losses"]
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} over {len(losses)} "
          f"steps; checkpoints: {out['mgr'].all_steps()}")
    if not losses[-1] < losses[0]:
        raise SystemExit("training did not descend")
    print("done")


if __name__ == "__main__":
    main()
