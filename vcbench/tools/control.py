#!/usr/bin/env python3
"""Readings that the correctness limits are set from, on the card.

    python3 vcbench/tools/control.py --workload qwen2-7b.chat \
        --seeds 11,12,13 --seconds 10

Serving cells: one set-up; for each seed the weights are made again in
place, a window of ``--seconds`` runs at the cell's load, and on the
sample that a run would check it prints the program's reading (the
widest gap of a served token below the float32 reference's best), the
control's (the gap of the token that the reference in fp8 puts first)
and a planted fault's (one served token altered).

Training cells: for each seed the program's three checked steps and the
float32 reference's, the control (the reference in fp8 in the program's
place) and a planted fault (the reference with half of each batch left
out, the mean taken over the rest), each compared with the float32
reference as a run compares the program.

One JSON line a seed; nothing of this runs in the benchmark's own runs.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "vcbench"))
sys.path.insert(0, str(ROOT / "src"))


def serve_readings(cell, seeds, seconds, device, bench_dir=None):
    import numpy as np
    from harness import check, weights
    from harness.manifest import reference
    from harness.serve import ServeCell
    from reference.common import precise
    Ref = reference(cell).Ref
    sc = ServeCell(cell, seeds[0], device, log=print)
    lim = cell.limits["sample"]
    model = cell.config["model"]
    out = []
    try:
        for seed in seeds:
            weights.refill(sc.weights, cell.config, seed)
            win = sc.window(seed, seconds)
            picks, _ = check.sample(win, int(sc.dep["max_len"]), sc.warmed,
                                    seed, lim, sc.exact)
            precise()
            ref = Ref(model)
            prog = check.served_gaps(ref, sc.weights, picks, device)
            ctrl = check.served_gaps(ref, sc.weights, picks, device,
                                     control=Ref(model, "fp8"))
            # a planted fault: the middle served token of the longest
            # request altered where the engine produced it
            s, r = picks[0]
            j = len(r.tokens) // 2
            bad = type(r)(r.uid, r.prompt, r.max_new_tokens, tenant=r.tenant)
            bad.tokens = list(r.tokens)
            bad.tokens[j] = (bad.tokens[j] + 1 + int(np.random.default_rng(
                seed).integers(model["vocab"] - 1))) % model["vocab"]
            fault = check.served_gaps(ref, sc.weights, [(s, bad)], device)
            row = {"seed": seed, "requests": len(picks),
                   "served_tokens": sum(len(r.tokens) for _, r in picks),
                   "program": max(prog), "control": max(ctrl),
                   "fault_token": max(fault),
                   "unfinished": sum(1 for s2 in win.foreground_sent()
                                     if s2.uid not in win.done)}
            print("reading " + json.dumps(row), flush=True)
            out.append(row)
    finally:
        sc.close()
    return out


def train_readings(cell, seeds, device, program=True):
    from harness import check
    from harness.train import (TrainCell, loss_gap, reference_numbers)
    config, mix = cell.config, cell.mix
    out = []
    for seed in seeds:
        t0 = time.monotonic()
        row = {"seed": seed}
        ref = reference_numbers(config, mix, seed, device)
        keep = check.moved_leaves(ref["grad1"])

        def gaps(losses, grad1, change):
            return {"loss_gap": loss_gap(losses, ref["losses"]),
                    "grad_gap": check.leaf_gap(grad1, ref["grad1"])[0],
                    "change_gap": check.leaf_gap(change, ref["change"],
                                                 keep)[0]}
        if program:
            tc = TrainCell(cell, seed, device, log=print)
            row["program"] = gaps(tc.losses, tc.grad1, tc.change3)
            tc.free()
            del tc
        c = reference_numbers(config, mix, seed, device, precision="fp8")
        row["control"] = gaps(c["losses"], c["grad1"], c["change"])
        half = dict(mix, batch=int(mix["batch"]) // 2)
        h = reference_numbers(config, half, seed, device)
        row["fault_half_batch"] = gaps(h["losses"], h["grad1"], h["change"])
        row["seconds"] = time.monotonic() - t0
        print("reading " + json.dumps(row), flush=True)
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--no-program", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from harness.manifest import load_cell
    cell = load_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    device = torch.device("cuda")
    if cell.mix["kind"] == "train":
        train_readings(cell, seeds, device, program=not args.no_program)
    else:
        serve_readings(cell, seeds, args.seconds, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
