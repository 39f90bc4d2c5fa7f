"""Multi-tenant serving through the control->data plane bridge, on the
PyTorch port (twin of ``examples/serve_multitenant.py``).

A ServingFleet hosts engine replicas as WorkUnits: the SuperScheduler
places ``engine-<i>`` units on nodes, each node agent's provider spawns a
live GenerationEngine with a dedicated drive thread, and tenant requests
flow through the shared per-tenant WRR SlotScheduler — so the bursty
tenant's flood cannot starve the steady tenant's admissions, and
per-tenant TTFT / token throughput land in the framework's metrics
registry (where the autoscaler's engine-replica actuator reads them).

    PYTHONPATH=src python examples/serve_multitenant_torch.py               # the card
    PYTHONPATH=src python examples/serve_multitenant_torch.py --device cpu

On the card each replica captures its decode step as one CUDA graph (and
the first call builds the kernels with ``nvcc``); on the CPU it runs the
plain versions at fp32. Both use the reference's reduced qwen2-7b.
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core import VirtualClusterFramework
from repro_torch.device import resolve_device
from repro_torch.models import init_params
from repro_torch.serving import GenerationEngine, ServingFleet


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    device = resolve_device(ap.parse_args().device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    cfg = reduced(get_config("qwen2-7b"), n_layers=2, d_model=64, vocab=512)
    params = init_params(cfg, device=device, dtype=dtype,
                         generator=torch.Generator(device).manual_seed(0))
    fleet = ServingFleet(
        lambda: GenerationEngine(cfg, params, slots=4, max_len=64,
                                 compute_dtype=dtype, device=device),
        replicas=1, scan_interval=0.1)

    fw = VirtualClusterFramework(num_nodes=2, scan_interval=0.0,
                                 heartbeat_interval=3600)
    fleet.attach(fw)
    with fw:
        # tenants register from their control planes; the steady tenant
        # gets double WRR weight at the admission scheduler
        bursty = fw.add_tenant("bursty")
        steady = fw.add_tenant("steady", weight=2)
        fleet.register_tenant(bursty)
        fleet.register_tenant(steady)
        # one spawn at a time: on the card two engines that capture their
        # decode graphs at once both fail (ROADMAP.md, section 3)
        for n in (1, 2):
            fleet.resize(n)
            while fleet.live_replicas() < n:
                time.sleep(0.01)
        for u in fw.super_api.list("WorkUnit", "vc-serving"):
            print(f"[fleet] {u.metadata.name} scheduled on "
                  f"{u.status.node or '?'} ({device})")

        rng = np.random.default_rng(0)
        uids = {}
        t0 = time.monotonic()
        # bursty tenant: 12 requests at once; steady: 4 paced
        for _ in range(12):
            uid = fleet.submit("bursty", rng.integers(0, cfg.vocab, 12),
                               max_new_tokens=8)
            uids[uid] = "bursty"
        for _ in range(4):
            uid = fleet.submit("steady", rng.integers(0, cfg.vocab, 12),
                               max_new_tokens=8)
            uids[uid] = "steady"
        done = fleet.wait_completed(len(uids), timeout=300)
        wall = time.monotonic() - t0

        by_tenant = {}
        for uid, req in done.items():
            by_tenant.setdefault(uids[uid], []).append(
                req.first_token_at - req.submitted_at)
        toks = sum(len(r.tokens) for r in done.values())
        print(f"served {len(done)} requests / {toks} tokens in {wall:.2f}s "
              f"({toks / wall:.0f} tok/s)")
        for name, ttfts in sorted(by_tenant.items()):
            print(f"  {name:7s}: {len(ttfts)} reqs, "
                  f"mean TTFT {sum(ttfts) / len(ttfts) * 1e3:.1f}ms")
        snap = fw.metrics.snapshot()
        for t in ("bursty", "steady"):
            s = snap["summaries"].get(
                f"serving_ttft_seconds{{tenant={t}}}", {})
            print(f"  metrics[{t}]: ttft_count={s.get('count', 0):.0f} "
                  f"tokens="
                  f"{snap['counters'].get(f'serving_tokens_total{{tenant={t}}}', 0):.0f}")
    print("done")


if __name__ == "__main__":
    main()
