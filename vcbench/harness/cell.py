"""One run of one cell: set-up, the measured window, the metrics, and the
check that decides ``correct``. ``run.py`` calls ``run_cell`` on the card;
the tests call it on the CPU at a tiny size."""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from . import check, stats
from .flops import counts
from .manifest import Cell, metric_reader, reference

NS = 1_000_000_000


@dataclass
class RunData:
    """What the per-layer readers read (``vcbench/metrics/<name>.py``);
    ``flops``: the chip's peaks and the configuration's counts
    (``flops.counts``)."""
    cell: Cell
    model: Dict[str, Any]
    seconds: float
    replica_ready_s: Optional[float] = None
    foreground: List[Tuple[Any, Any]] = field(default_factory=list)
    admits: list = field(default_factory=list)        # spans in the window
    steps: list = field(default_factory=list)
    slice: Any = None                                 # kineto.Slice
    slice_admits: list = field(default_factory=list)  # spans in the slice
    slice_steps: list = field(default_factory=list)
    train_steps: List[Tuple[int, int]] = field(default_factory=list)
    train_profiled: Optional[int] = None
    flops: Any = None
    stats: Any = stats

    def __post_init__(self):
        if self.flops is None:
            self.flops = counts(self.cell.config)


def _p(values: List[float], q: float) -> float:
    return stats.pct(values, q)


# ---------------------------------------------------------------- serving

def _serve(cell: Cell, seed: int, seconds: float, trace: bool,
           device: torch.device, t_start: float, log: Callable,
           limit: Callable) -> Tuple[Dict, Dict, RunData, Dict]:
    from reference.common import precise
    from .admission import groups, histogram, tokens_between
    from .serve import ServeCell
    t_cell = time.monotonic()
    sc = ServeCell(cell, seed, device, log=log, trace=trace)
    setup_s = time.monotonic() - t_start
    log(f"set-up {setup_s:.3f} s (imports and the device "
        f"{t_cell - t_start:.3f} s, "
        f"{ {k: round(v, 3) for k, v in sc.phases.items()} }, the engine's "
        f"constructor {sc.engine_build_s:.3f} s); warmed admission shapes "
        f"(rows, bucket) {sc.warmed}")
    win = sc.window(seed, seconds, trace=trace)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    model = cell.config["model"]
    fg = [(s, win.done.get(s.uid)) for s in win.foreground_sent()]
    ttft, tpot = [], []
    for s, r in fg:
        if r is None:       # never came: counted as the longest wait
            ttft.append((win.waited_until - s.due_ns) / 1e6)
            tpot.append((win.waited_until - s.due_ns) / 1e6)
            continue
        ttft.append((r.first_token_at * NS - s.due_ns) / 1e6)
        tpot.append((r.finished_at - r.first_token_at) * 1e3
                    / max(1, len(r.tokens) - 1))
    generated = sum(tokens_between(r, win.t0 / NS, win.t1 / NS)
                    for r in win.served)
    e2e = {"ttft_p95_ms": _p(ttft, 95),
           "tpot_p95_ms": _p(tpot, 95),
           "output_tokens_per_s": generated / win.seconds,
           "setup_s": setup_s}
    # earlier lines: per tenant, the generator, admission, the engine
    for tenant in sorted({s.tenant for s in win.sent}):
        t = [(r.first_token_at * NS - s.due_ns) / 1e6 for s in win.sent
             if s.tenant == tenant and (r := win.done.get(s.uid)) is not None]
        n = sum(1 for s in win.sent if s.tenant == tenant)
        log(f"tenant {tenant}: {n} sent, {len(t)} finished, TTFT p50 "
            f"{_p(t, 50):.2f} ms p95 {_p(t, 95):.2f} ms")
    late = [(s.sent_ns - s.due_ns) / 1e6 for s in win.sent]
    log(f"generator lateness: p50 {_p(late, 50):.3f} ms, p99 "
        f"{_p(late, 99):.3f} ms, max {max(late, default=0.0):.3f} ms over "
        f"{len(late)} submissions ({win.closed_sent} of closed-loop "
        f"tenants)")
    max_len = int(cell.config["deployment"]["max_len"])
    met = [g for g in groups(win.served, max_len, sc.warmed, sc.exact)
           if win.t0 <= g.started * NS < win.t1]
    new_shapes = sorted({g.shape for g in met if g.eager})
    c0, c1 = win.counters
    log(f"admission calls in the window by shape (rows x bucket): "
        f"{histogram(met)}; first met in the window (eager, then captured): "
        f"{len(new_shapes)} {new_shapes}; counters {c1} (window: "
        f"{ {k: c1[k] - c0[k] for k in c1} }); {generated:.1f} tokens in "
        f"the window")
    run = RunData(cell, model, win.seconds, sc.replica_ready_s, fg)
    breakdown = None
    if win.slice is not None:
        # the probe's host-clock spans (traced runs only) and the requests
        # from before the slice, which the profiler slows
        run.admits, run.steps = sc.probe.between(win.t0, win.slice_mono[0])
        run.seconds = (win.slice_mono[0] - win.t0) / NS
        run.foreground = [(s, r) for s, r in fg
                          if s.due_ns < win.slice_mono[0]]
        run.slice = win.slice
        run.slice_admits, run.slice_steps = sc.probe.within(*win.slice_mono)
        breakdown = win.slice.breakdown("park")
    # the check, once the window has closed and the program is freed
    lim = cell.limits
    picks, covers = check.sample(win, max_len, sc.warmed, seed,
                                 lim["sample"], sc.exact)
    unfinished = sum(1 for _, r in fg if r is None)
    wrong = sum(1 for s in win.sent if s.uid in win.done
                and len(win.done[s.uid].tokens) != s.max_new)
    weights = sc.weights
    sc.close()
    del sc
    t_ref = time.monotonic()
    precise()
    gaps = check.served_gaps(reference(cell).Ref(model), weights, picks,
                             device)
    log(f"check: {len(picks)} requests, {sum(len(r.tokens) for _, r in picks)}"
        f" served tokens, covering {covers}; widest gap each {gaps}; "
        f"reference {time.monotonic() - t_ref:.2f} s")
    checks = {"served_gap": limit("served_gap", max(gaps, default=math.inf)),
              "unfinished": limit("unfinished", unfinished),
              "wrong_length": limit("wrong_length", wrong)}
    counts = {"attempted": len(fg), "failed": unfinished, "peak": peak,
              "breakdown": breakdown}
    return e2e, checks, run, counts


# ---------------------------------------------------------------- training

def _train(cell: Cell, seed: int, seconds: float, trace: bool,
           device: torch.device, t_start: float, log: Callable,
           limit: Callable) -> Tuple[Dict, Dict, RunData, Dict]:
    from .train import CHECK_STEPS, TrainCell, loss_gap, reference_numbers
    tc = TrainCell(cell, seed, device, log=log)
    setup_s = time.monotonic() - t_start
    log(f"set-up {setup_s:.3f} s (the first {CHECK_STEPS} steps included): "
        f"losses {tc.losses}")
    win = tc.window(seconds, trace=trace)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    steps = win["steps"]
    span = (win["t1"] - win["t0"]) / NS
    e2e = {"train_tokens_per_s": len(steps) * tc.tokens_per_step / span,
           "setup_s": setup_s}
    ms = [(b - a) / 1e6 for a, b in steps]
    log(f"window: {len(steps)} steps in {span:.3f} s, step ms {ms}, losses "
        f"{win['losses']}")
    run = RunData(cell, cell.config["model"], span, train_steps=steps)
    breakdown = None
    if win["slice"] is not None:
        run.slice = win["slice"]
        run.train_profiled = int(cell.mix.get("slice_step", 1))
        breakdown = run.slice.breakdown("between steps")
    failed = sum(1 for x in win["losses"] if not math.isfinite(x))
    prog_losses = tc.losses[:CHECK_STEPS]
    grad1, change3 = tc.grad1, tc.change3
    tc.free()
    del tc
    t_ref = time.monotonic()
    ref = reference_numbers(cell.config, cell.mix, seed, device)
    keep = check.moved_leaves(ref["grad1"])
    lg = loss_gap(prog_losses, ref["losses"])
    gg, g_at = check.leaf_gap(grad1, ref["grad1"])
    cg, c_at = check.leaf_gap(change3, ref["change"], keep)
    log(f"check: losses {prog_losses} against the reference's "
        f"{ref['losses']}; worst first-gradient leaf {g_at} ({gg!r}), worst "
        f"change leaf {c_at} ({cg!r}); {len(ref['grad1']) - len(keep)} "
        f"leaves left out of the change (gradient under 1e-3 of the median "
        f"leaf's); reference {time.monotonic() - t_ref:.2f} s")
    checks = {"loss_gap": limit("loss_gap", lg),
              "grad_gap": limit("grad_gap", gg),
              "change_gap": limit("change_gap", cg)}
    counts = {"attempted": len(steps), "failed": failed, "peak": peak,
              "breakdown": breakdown}
    return e2e, checks, run, counts


# ---------------------------------------------------------------- a run

def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float,
             log: Callable = print) -> Dict[str, Any]:
    """One run; returns the result line's object, "checks" last. A
    configuration that its reference module does not cover stops here."""
    reference(cell)

    def limit(name, value):
        return {"value": float(value), "limit": float(cell.limits[name]
                                                      ["limit"])}
    drive = _train if cell.mix["kind"] == "train" else _serve
    e2e, checks, run, counts = drive(cell, seed, seconds, trace, device,
                                     t_start, log, limit)
    ok = check.report(checks)
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = metric_reader(m.name)(run)
            if value is not None:
                metrics[m.name] = {"value": float(value), "unit": m.unit}
    else:
        metrics = {m.name: {"value": float(e2e[m.name]), "unit": m.unit}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(counts["peak"])}
    out: Dict[str, Any] = {"correct": ok, "attempted": counts["attempted"],
                           "failed": counts["failed"], "metrics": metrics,
                           "device": dev}
    if trace and run.slice is not None:
        dev["busy_s"] = run.slice.busy_s()
        dev["window_s"] = run.slice.window_s
        out["breakdown"] = counts["breakdown"]
    out["checks"] = {k: v for k, v in checks.items()}
    return out
