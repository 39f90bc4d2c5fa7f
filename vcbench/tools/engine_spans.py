#!/usr/bin/env python3
"""Where a serving cell's decode step goes, from the engine's own spans,
on the card.

    python3 vcbench/tools/engine_spans.py --workload qwen2-7b.chat \
        --seed 7 --seconds 51

One traced run of the cell, as ``vcbench/run.py --trace 1`` makes it, but
with the engine's span lane on: once the replica's engine is built and its
shapes warmed, ``engine.tracer`` is set to a ``Tracer``
(``repro_torch.core.trace``), as the probe is put on. Prints the run's
result line, then one JSON line ``{"engine_spans": {...}}``
(``harness/spans.py:figures``): over the window before the slice, the mean
device time of a step graph (``decode_graph_ms``), of the device's idle
gap between consecutive step graphs (``decode_gap_ms``), of an admit
call's device work (``admit_graph_ms``), the mean interval between
consecutive step launches on the host, and each host span's mean length;
over the profiled slice, the drive thread's wake-up after a step's copy
(``sync_wake_ms``), the idle time split by the span the drive thread was
in (``idle_host.serve``, ``idle_split_pct``), and how far the program's
graph launches lie from the profiler's (``graph_launch_residual_us``).
"""
import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.monotonic()
ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT / "vcbench"))
sys.path.insert(0, str(ROOT / "src"))

NS = 1_000_000_000


def traced_run(cell, seed, seconds, device, t_start, log=print):
    """One traced run of the serving ``cell`` with the engine's span lane
    on. Returns (the run's result object, the spans' figures)."""
    from harness import cell as cell_mod
    from harness import serve
    from harness.spans import Reading, figures
    from repro_torch.core.trace import Tracer

    class ReadingTracer(Tracer):
        """Keeps each device duration with the host time it was read at,
        so that the window's can be chosen by time."""
        lane_capacity = 1 << 18

        def __init__(self):
            super().__init__()
            self.readings = []

        def lane_add(self, name, seconds):
            self.readings.append(Reading(time.monotonic(), name, seconds))
            super().lane_add(name, seconds)

    held = {}

    class TracedCell(serve.ServeCell):
        def _factory(self):
            engine = super()._factory()
            engine.tracer = held["tracer"] = ReadingTracer()
            return engine

        def window(self, *args, **kwargs):
            held["window"] = super().window(*args, **kwargs)
            return held["window"]

    plain = serve.ServeCell
    serve.ServeCell = TracedCell
    try:
        out = cell_mod.run_cell(cell, seed, seconds, True, device, t_start,
                                log)
    finally:
        serve.ServeCell = plain
    win, tr = held["window"], held["tracer"]
    hi = win.slice_mono[0] if win.slice_mono else win.t1
    return out, figures(tr.readings, tr.lane_records(),
                        (win.t0 / NS, hi / NS), win.slice, win.slice_mono)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    import torch
    from harness.manifest import load_cell
    cell = load_cell(args.workload)
    if cell.mix["kind"] != "serve" or not torch.cuda.is_available():
        print("engine_spans: a serving cell, on the card", file=sys.stderr)
        return 2

    def log(msg):
        print(f"engine_spans {args.workload}: {msg}", flush=True)

    out, fig = traced_run(cell, args.seed, args.seconds,
                          torch.device("cuda"), T_START, log)
    print(json.dumps(out), flush=True)
    print(json.dumps({"engine_spans": fig}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
