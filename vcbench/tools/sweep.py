#!/usr/bin/env python3
"""The knee sweep of a serving cell, on the card: the highest rate that the
fleet sustains.

    python3 vcbench/tools/sweep.py --workload qwen2-7b.chat --seed 5 \
        --seconds 20 --scales 0.75,1,1.25,1.5,1.75,2

One set-up, then one window a scale (``--repeat`` windows, each with
its own seed), every open-loop rate of the cell's
mix multiplied by the scale (each window waits until all it sent has
finished). Prints one JSON line a scale: the offered rate, the
foreground's TTFT and TPOT p50/p95, how many requests were still waiting
for a slot when the window closed, the tokens generated a second, the
mean of the slots in use, and the admission calls by (rows, bucket)
shape, with the shapes first met in the window.
The knee is the highest rate at which the backlog does not grow through
the window. The benchmark's own runs never sweep: a cell's rate is fixed
in its mix file.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "vcbench"))
sys.path.insert(0, str(ROOT / "src"))

NS = 1_000_000_000


def sweep(cell, seed, seconds, scales, device, repeat=1):
    from harness.admission import (groups, histogram, live_between,
                                   tokens_between)
    from harness.serve import ServeCell
    from harness.stats import pct
    sc = ServeCell(cell, seed, device, log=print)
    base = sum(float(t["rate"]) for t in cell.mix["tenants"]
               if t["arrival"] != "closed")
    out = []
    try:
        for i, (scale, j) in enumerate((s, j) for s in scales
                                       for j in range(repeat)):
            win = sc.window(seed + i + 1, seconds, rate_scale=scale)
            fg = [(s, win.done.get(s.uid)) for s in win.foreground_sent()]
            ttft = [(r.first_token_at * NS - s.due_ns) / 1e6
                    for s, r in fg if r is not None]
            tpot = [(r.finished_at - r.first_token_at) * 1e3
                    / max(1, len(r.tokens) - 1) for s, r in fg
                    if r is not None]
            waiting = sum(1 for s in win.sent
                          if (r := win.done.get(s.uid)) is None
                          or r.dequeued_at * NS > win.t1)
            lo, hi = win.t0 / NS, win.t1 / NS
            toks = sum(tokens_between(r, lo, hi) for r in win.served)
            live = sum(live_between(r, lo, hi) for r in win.served)
            met = [g for g in groups(win.served, int(sc.dep["max_len"]),
                                     sc.warmed, sc.exact)
                   if lo <= g.started < hi]
            row = {"scale": scale, "repeat": j, "rate": base * scale,
                   "sent": len(win.sent), "unfinished":
                   sum(1 for _, r in fg if r is None),
                   "ttft_p50_ms": pct(ttft, 50), "ttft_p95_ms": pct(ttft, 95),
                   "tpot_p50_ms": pct(tpot, 50), "tpot_p95_ms": pct(tpot, 95),
                   "waiting_at_close": waiting,
                   "output_tokens_per_s": toks / win.seconds,
                   "active_slots_mean": live / win.seconds,
                   "admission_shapes": histogram(met),
                   "first_met": sorted({g.shape for g in met if g.eager})}
            print("sweep " + json.dumps(row), flush=True)
            out.append(row)
    finally:
        sc.close()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--scales", required=True)
    ap.add_argument("--repeat", type=int, default=1,
                    help="windows a scale, each with its own seed")
    args = ap.parse_args(argv)
    import torch
    from harness.manifest import load_cell
    cell = load_cell(args.workload)
    sweep(cell, args.seed, args.seconds,
          [float(s) for s in args.scales.split(",")], torch.device("cuda"),
          args.repeat)
    return 0


if __name__ == "__main__":
    sys.exit(main())
