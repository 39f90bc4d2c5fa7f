"""Serving launcher (twin of ``repro.launch.serve``): continuous-batched
generation over a model, on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-7b \
        --reduced --requests 16 --max-new 24 --slots 4

Requests are spread across tenants through the batcher's per-tenant WRR
slot scheduler; the report includes per-tenant TTFT and the fused
engine's counters (steps, admit calls, host syncs).
Weights are random, drawn from ``--seed``, stored in bf16 where the
reference casts them to the compute dtype. As in the reference, no frames
or patches go in: seamless's decoder cross-attends to a zero cross cache,
and internvl2-2b serves as a text model.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-dense")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--tenants", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_config, reduced
    from ..device import resolve_device
    from ..models import init_params
    from ..serving import ContinuousBatcher, GenerationEngine

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, generator=gen, device=device)
    engine = GenerationEngine(cfg, params, slots=args.slots,
                              max_len=args.max_len, device=device)
    batcher = ContinuousBatcher(engine)
    rng = np.random.default_rng(args.seed)
    t0 = time.monotonic()
    for i in range(args.requests):
        batcher.submit(rng.integers(0, cfg.vocab, args.prompt_len),
                       max_new_tokens=args.max_new,
                       tenant=f"t{i % max(1, args.tenants)}")
    batcher.run_until_drained()
    wall = time.monotonic() - t0
    done = batcher.completed.values()
    lats = sorted(r.finished_at - r.submitted_at for r in done)
    toks = sum(len(r.tokens) for r in done)
    c = engine.counters()
    print(f"served {len(batcher.completed)} requests, {toks} tokens in "
          f"{wall:.2f}s ({toks/wall:.1f} tok/s); "
          f"p50 latency {lats[len(lats)//2]:.2f}s; "
          f"steps {c['steps']}, admit_calls {c['admit_calls']}, "
          f"host_syncs {c['host_syncs']}")
    by_tenant = {}
    for r in done:
        by_tenant.setdefault(r.tenant, []).append(
            r.first_token_at - r.submitted_at)
    for tenant, ttfts in sorted(by_tenant.items()):
        print(f"  {tenant}: {len(ttfts)} reqs, "
              f"mean TTFT {sum(ttfts)/len(ttfts)*1e3:.1f}ms, "
              f"max {max(ttfts)*1e3:.1f}ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
