"""Fault tolerance on the PyTorch port: node failure mid-stream plus a
checkpoint restart (twin of ``examples/elastic_failover.py``).

A tenant streams training WorkUnits; the node they run on is killed; the
scheduler re-binds the next unit to a healthy node and its provider
resumes from the last checkpoint of the port's ``CheckpointManager``, with
no tenant-visible API change. The train steps run on the card unless
``--device cpu``.

    PYTHONPATH=src python examples/elastic_failover_torch.py --device cpu
"""
import argparse
import sys
import tempfile
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import (CallableProvider,  # noqa: E402
                              VirtualClusterFramework)
from repro_torch.data import DataConfig, SyntheticTokens  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.config import ShapeConfig  # noqa: E402
from repro_torch.training import (OptimizerConfig,  # noqa: E402
                                  make_opt_state, make_train_step)


def run(device=None, ckpt_dir: str = "", log=print) -> dict:
    """The scenario; returns {"u0", "u1": (node, result), "steps": the
    checkpoints after the failover}."""
    device = resolve_device(device)
    cfg = reduced(get_config("yi-9b"), d_model=64, n_layers=2, vocab=512)
    shape = ShapeConfig("demo", 64, 4, "train")
    step_fn = make_train_step(cfg, OptimizerConfig(peak_lr=1e-3))
    data = SyntheticTokens(cfg, shape, DataConfig(seed=0))
    mgr = CheckpointManager(ckpt_dir or tempfile.mkdtemp(
        prefix="vc-failover-demo-torch-"), keep=2)

    def make_provider(node_name):
        """Each node restores from the latest checkpoint before running,
        as a fresh host does after taking over a failed job."""
        def run_unit(unit):
            gen = torch.Generator(device=device).manual_seed(0)
            params = init_params(cfg, generator=gen, device=device,
                                 dtype=torch.float32)
            opt = make_opt_state(params)
            start = 0
            if mgr.latest_step() is not None:
                (params, opt), start = mgr.restore((params, opt))
            base = unit.spec.payload["base_step"]
            loss = None
            for s in range(max(base, start), base + 5):
                params, opt, metrics = step_fn(params, opt, data.batch_at(s))
                loss = float(metrics["loss"])
            mgr.save(base + 5, (params, opt), block=True)
            return {"node": node_name, "loss": loss, "resumed_from": start}
        return CallableProvider(run_unit)

    fw = VirtualClusterFramework(num_nodes=3, scan_interval=0.0,
                                 heartbeat_interval=3600,
                                 provider_factory=make_provider)
    with fw:
        tenant = fw.add_tenant("resilient-team")
        fw.submit(tenant, fw.make_unit("u0", "jobs", chips=1,
                                       payload={"base_step": 0}))
        u0 = fw.wait_ready(tenant, "jobs", "u0", timeout=120)
        node0 = u0.status.node
        log(f"u0 ran on {node0} ({device}), checkpoints: {mgr.all_steps()}")

        # kill that node, then submit the next unit
        fw.super_api.update_status(
            "Node", "", node0, lambda n: setattr(n.status, "phase",
                                                 "NotReady"))
        fw.scheduler.node_failed(node0)
        log(f"killed {node0}")
        fw.submit(tenant, fw.make_unit("u1", "jobs", chips=1,
                                       payload={"base_step": 5}))
        u1 = fw.wait_ready(tenant, "jobs", "u1", timeout=120)
        agent = fw.agents[u1.status.node]
        result = list(agent.provider.results.values())[-1]
        log(f"u1 rescheduled to {u1.status.node} (resumed from checkpoint "
            f"step {result['resumed_from']}, loss {result['loss']:.3f})")
        if u1.status.node == node0:
            raise SystemExit("ERROR: u1 ran on the failed node")
        log(f"checkpoints after failover: {mgr.all_steps()}")
    return {"u0": node0, "u1": (u1.status.node, result),
            "steps": mgr.all_steps()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    ap.add_argument("--ckpt-dir", default="")
    args = ap.parse_args(argv)
    run(args.device, args.ckpt_dir, log=lambda m: print(m, flush=True))
    print("done")


if __name__ == "__main__":
    main()
