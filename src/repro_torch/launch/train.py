"""Training launcher (twin of ``repro.launch.train``, local mode): trains
--arch (reduced or full) on one device with the data pipeline,
checkpointing and restart. Runs on the card unless ``--device cpu``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-7b \
        --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tiny-dense")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the arch to a CPU-sized config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU (default: the card)")
    args = ap.parse_args(argv)

    import torch

    from ..ckpt import CheckpointManager
    from ..configs import get_config, reduced
    from ..data import DataConfig, Prefetcher, SyntheticTokens
    from ..device import resolve_device
    from ..models import init_params
    from ..models.config import ShapeConfig
    from ..training import OptimizerConfig, make_opt_state, make_train_step
    from ..training.optimizer import tree_leaves

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    shape = ShapeConfig("local", args.seq, args.batch, "train")
    opt_cfg = OptimizerConfig(peak_lr=args.lr, warmup_steps=args.steps // 10,
                              total_steps=args.steps)

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, generator=gen, device=device,
                         dtype=torch.float32)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.2f}M "
          f"tokens/step={shape.tokens}")
    step_fn = make_train_step(cfg, opt_cfg, microbatches=args.microbatches)
    opt = make_opt_state(params)

    start_step = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=3)
        if args.resume and mgr.latest_step() is not None:
            (params, opt), start_step = mgr.restore((params, opt))
            print(f"resumed from step {start_step}")

    data = SyntheticTokens(cfg, shape, DataConfig(seed=args.seed))
    it = Prefetcher(iter(data), depth=2)
    t0 = time.monotonic()
    tokens_done = 0
    for i, batch in zip(range(start_step, args.steps), it):
        params, opt, metrics = step_fn(params, opt, batch)
        tokens_done += int(metrics["tokens"])
        if (i + 1) % args.log_every == 0 or i + 1 == args.steps:
            dt = time.monotonic() - t0
            print(f"step {i+1:5d} loss={float(metrics['loss']):.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.2f} "
                  f"tok/s={tokens_done/dt:.0f}", flush=True)
        if mgr and (i + 1) % args.ckpt_every == 0:
            mgr.save(i + 1, (params, opt))
    if mgr:
        mgr.save(args.steps, (params, opt), block=True)
    it.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
