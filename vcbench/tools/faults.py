#!/usr/bin/env python3
"""Planted faults in the program's expert and Mamba layers, against a
serving cell's check, on the card.

    python3 vcbench/tools/faults.py --workload jamba2-mini.chat \
        --seeds 11,12 --seconds 10

For each seed: a sound set-up and window, and on the sample that a run
would check the program's reading (the widest gap of a served token
below the float32 reference's best) and the control's (the gap of the
token that the reference in fp8 puts first); then, for each fault, a new
set-up with the fault planted in the program before its engine is built
(its decode step is captured then), a window, and its reading. The
faults (``FAULTS``):

- ``dropped_pair``: each expert layer's call drops one routed pair, the
  first token's highest-weighted, as a capacity past its tokens would;
- ``renormalised``: the router's top-k weights renormalised to sum to 1;
- ``no_inner_norms``: the Mamba mixer's norms of dt, B and C left out.

Each is a departure of the published block that a program of this
configuration could make; each has to fail the check. One JSON line a
reading, with the engine's MoE counters; nothing of this runs in the
benchmark's own runs. ``vcbench/tests/test_vcbench_jamba.py`` plants the
same faults on the CPU.
"""
import argparse
import contextlib
import dataclasses
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "vcbench"))
sys.path.insert(0, str(ROOT / "src"))


def _dropped_pair(setattr_):
    import torch
    from repro_torch.models import moe
    route = moe._route

    def faulty(x, router, cfg):
        e_s, t_s, g_s, rank, keep = route(x, router, cfg)
        first = torch.where(t_s == 0, g_s, -1.0).argmax()
        keep = keep & (torch.arange(keep.numel(), device=keep.device)
                       != first)
        return e_s, t_s, g_s, rank, keep
    setattr_(moe, "_route", faulty)


def _renormalised(setattr_):
    from repro_torch.models import moe
    gates = moe._gates

    def faulty(x, router, cfg):
        return gates(x, router, dataclasses.replace(cfg, router_renorm=True))
    setattr_(moe, "_gates", faulty)


def _no_inner_norms(setattr_):
    from repro_torch.models import mamba

    def unnormed(x, scale, eps=1e-6, zero_centered=False):
        return x
    setattr_(mamba, "rms_norm", unnormed)


FAULTS = {"dropped_pair": _dropped_pair, "renormalised": _renormalised,
          "no_inner_norms": _no_inner_norms}


@contextlib.contextmanager
def planted(name):
    """The program with fault ``name`` planted, restored on exit."""
    saved = []

    def setattr_(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)
    try:
        FAULTS[name](setattr_)
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)


def reading(cell, seed, seconds, device, fault=None, control=False):
    """One set-up and window of ``cell`` (with ``fault`` planted), and the
    check's reading on its sample: a dict."""
    import torch
    from harness import check
    from harness.manifest import reference
    from harness.serve import ServeCell
    from reference.common import precise
    t0 = time.monotonic()
    with planted(fault) if fault else contextlib.nullcontext():
        sc = ServeCell(cell, seed, device, log=lambda m: None)
        try:
            win = sc.window(seed, seconds)
            counters = sc.engines[0].counters()
            picks, _ = check.sample(win, int(sc.dep["max_len"]), sc.warmed,
                                    seed, cell.limits["sample"], sc.exact)
            unfinished = sum(1 for s in win.foreground_sent()
                             if s.uid not in win.done)
        finally:
            sc.close()
    weights = sc.weights
    del sc
    precise()
    Ref, model = reference(cell).Ref, cell.config["model"]
    t_ref = time.monotonic()
    gaps = check.served_gaps(Ref(model), weights, picks, device)
    row = {"seed": seed, "fault": fault or "sound", "requests": len(picks),
           "served_tokens": sum(len(r.tokens) for _, r in picks),
           "program": max(gaps), "unfinished": unfinished,
           "moe_pairs": counters.get("moe_pairs"),
           "moe_pairs_dropped": counters.get("moe_pairs_dropped"),
           "reference_s": time.monotonic() - t_ref}
    if control:
        row["control"] = max(check.served_gaps(
            Ref(model), weights, picks, device, control=Ref(model, "fp8")))
    row["seconds"] = time.monotonic() - t0
    del weights
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--faults", default=",".join(FAULTS))
    args = ap.parse_args(argv)
    import torch
    from harness.manifest import load_cell
    cell = load_cell(args.workload)
    device = torch.device("cuda")
    faults = [f for f in args.faults.split(",") if f]
    for seed in (int(s) for s in args.seeds.split(",")):
        print("reading " + json.dumps(reading(cell, seed, args.seconds,
                                              device, control=True)),
              flush=True)
        for fault in faults:
            print("reading " + json.dumps(reading(cell, seed, args.seconds,
                                                  device, fault)),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
