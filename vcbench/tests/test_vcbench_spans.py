"""The readers of the engine's own spans (``harness/spans.py``) on
synthetic spans, device events and slices, and the span tool
(``tools/engine_spans.py``) end to end on the CPU at a tiny size, where
the engine has no device clock."""
import importlib.util
import time
from pathlib import Path

import pytest
import torch

from harness import serve
from harness import spans as S
from harness.kineto import DeviceEvent, Slice
from harness.manifest import load_cell

DATA = Path(__file__).resolve().parent / "data"
TOOL = Path(__file__).resolve().parents[1] / "tools" / "engine_spans.py"
MS = 1_000_000


def _rec(name, start_ms, end_ms, attrs=()):
    return (name, start_ms / 1e3, end_ms / 1e3, attrs)


def test_device_and_span_means_take_the_window_only():
    readings = [S.Reading(0.5, "engine.step.device", 0.006),
                S.Reading(1.5, "engine.step.device", 0.007),
                S.Reading(1.6, "engine.step.device", 0.009),
                S.Reading(1.7, "engine.step.gap", 0.004),
                S.Reading(2.5, "engine.step.gap", 0.1)]
    assert S.device_ms(readings, "engine.step.device", 1.0, 2.0) == \
        pytest.approx(8.0)
    assert S.device_ms(readings, "engine.step.gap", 1.0, 2.0) == \
        pytest.approx(4.0)
    assert S.device_ms(readings, "engine.admit.device", 1.0, 2.0) is None
    records = [_rec("engine.step.wait", 900, 1100),     # ends in the window
               _rec("engine.step.wait", 1200, 1500),
               _rec("engine.step.wait", 1900, 2100)]    # ends after it
    assert S.span_ms(records, "engine.step.wait", 1.0, 2.0) == \
        pytest.approx(250.0)


def test_launch_interval_pairs_consecutive_steps_without_admission():
    """Steps launch at 0, 10, 21 ms, an admit call at 25 ms, steps at 40
    and 52 ms: the pairs (0, 10), (10, 21) and (40, 52), chosen by the
    second step's end (its book span); the window [0.015, 1) keeps the
    last two."""
    records = []
    for t in (0, 10, 21, 40, 52):
        records += [_rec("engine.step.launch", t, t + 1),
                    _rec("engine.step.book", t + 7, t + 8)]
    records.append(_rec("engine.admit.launch", 25, 30))
    assert S.launch_interval_ms(records, 0.0, 1.0) == pytest.approx(
        (10 + 11 + 12) / 3)
    assert S.launch_interval_ms(records, 0.020, 1.0) == pytest.approx(
        (11 + 12) / 2)
    assert S.launch_interval_ms(records[:2], 0.0, 1.0) is None


def test_spans_move_onto_the_profiler_clock():
    records = [_rec("a", 1000, 1002), _rec("b", 5000, 5001),
               _rec("c", 999, 1000.5)]
    spans = S.on_profiler_clock(records, 10 * MS, 1009 * MS, 1011 * MS)
    assert [(s.name, s.start_ns, s.end_ns) for s in spans] == [
        ("c", 1009 * MS, 1010 * MS + MS // 2), ("a", 1010 * MS, 1012 * MS)]


def _slice(busy, lo=0, hi=100, extra=(), cpu=()):
    dev = [DeviceEvent("kernel", a * MS, b * MS, 0) for a, b in busy]
    dev += [DeviceEvent(n, a * MS, b * MS, 0) for n, a, b in extra]
    return Slice(dev, [], list(cpu), lo * MS, hi * MS)


def _span(name, a, b):
    return S.Span(name, int(a * MS), int(b * MS))


def test_idle_split_parts_sum_to_the_idle_time():
    """Busy 0-20, 30-60, 70-80 of a 100-ms slice (idle 40 ms). The drive
    thread: a step's launch 18-22 (2 ms of idle in host work), its wait
    22-35 (8 ms in a wait), book and finish 35-40 (none idle), outside any
    span 40-62 (2 ms idle), park 62-75 (8 ms idle), take 85-86 (1 ms host;
    the other 19 ms outside)."""
    sl = _slice([(0, 20), (30, 60), (70, 80)])
    spans = [_span("engine.step.launch", 18, 22),
             _span("engine.step.wait", 22, 35),
             _span("engine.step.book", 35, 37),
             _span("replica.finish", 37, 40),
             _span("replica.park", 62, 75),
             _span("replica.take", 85, 86)]
    split = S.idle_split(sl, spans)
    assert split["wait"] == pytest.approx(8e-3)
    assert split["host"] == pytest.approx(3e-3)
    assert split["parked_or_outside"] == pytest.approx(29e-3)
    assert sum(split.values()) == pytest.approx(0.040)


def test_sync_wake_reads_the_last_copy_inside_each_wait():
    """Two step waits: copies end 0.3 ms and 0.05 ms before them; a copy
    of an admit call outside any step wait is ignored, and so is a wait
    with no copy in it."""
    sl = _slice([], extra=[("Memcpy DtoH (Device -> Pageable)", 11, 11.7),
                           ("Memcpy DtoH (Device -> Pageable)", 31, 31.95),
                           ("Memcpy DtoH (Device -> Pageable)", 50, 50.5),
                           ("Memcpy HtoD (Pageable -> Device)", 31.96,
                            31.97)])
    spans = [_span("engine.step.wait", 5, 12), _span("engine.step.wait",
                                                     25, 32),
             _span("engine.admit.wait", 49, 51),
             _span("engine.step.wait", 70, 75)]
    assert S.sync_wake_ms(sl, spans) == pytest.approx((0.3 + 0.05) / 2)
    assert S.sync_wake_ms(sl, []) is None


class _Runtime:
    def __init__(self, name, a, b):
        self._n, self._a, self._b = name, int(a * MS), int(b * MS)

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b


def test_graph_launch_residual():
    """Launch calls inside their spans read 0; one that ends 0.04 ms after
    its span, 40 µs; calls outside the slice and other calls are not
    counted."""
    cpu = [_Runtime("cudaGraphLaunch", 10.1, 10.2),
           _Runtime("cudaGraphLaunch", 20.5, 21.04),
           _Runtime("cudaLaunchKernel", 40, 41),
           _Runtime("cudaGraphLaunch", 150, 151)]
    sl = _slice([], cpu=cpu)
    spans = [_span("engine.step.launch", 10, 10.5),
             _span("engine.admit.launch", 20, 21),
             _span("engine.step.wait", 21, 30)]
    n, worst = S.graph_launch_residual_us(sl, spans)
    assert n == 2 and worst == pytest.approx(40.0)
    assert S.graph_launch_residual_us(sl, spans[:1])[1] == \
        pytest.approx(10_540.0)


def test_launch_shift_puts_every_graph_launch_inside_its_span():
    """Launch calls 0.15 ms after their spans' starts, the spans 1 ms long
    and the calls 0.5 ms: any shift in [-0.35, 0.15] ms puts each inside;
    the middle, -0.1 ms, is taken, and the residual after it is 0."""
    cpu = [_Runtime("cudaGraphLaunch", t + 0.15, t + 0.65)
           for t in (10, 22, 34)]
    sl = _slice([], cpu=cpu)
    spans = [_span("engine.step.launch", t, t + 1) for t in (10, 22)] + \
        [_span("engine.admit.launch", 34, 35), _span("engine.step.wait",
                                                     35, 40)]
    shift = S.launch_shift_ns(sl, spans)
    assert shift == pytest.approx(-0.1 * MS)
    moved = [S.Span(s.name, s.start_ns + shift, s.end_ns + shift)
             for s in spans]
    assert S.graph_launch_residual_us(sl, moved) == (3, 0.0)
    assert S.launch_shift_ns(_slice([]), spans) is None


def test_graph_anatomy_reads_each_replay_from_its_launch_on():
    """Two step graphs and an admission graph: each one's device work from
    its launch call to the next call, host copies left out; span, busy
    (the union: 2-3 and 2.5-4 overlap), idle, the call's time and the wait
    for its first kernel; the gap between the step graphs (none across the
    admission)."""
    cpu = [_Runtime("cudaGraphLaunch", 1, 1.5),
           _Runtime("cudaGraphLaunch", 10, 10.5),
           _Runtime("cudaGraphLaunch", 20, 20.2)]
    dev = [DeviceEvent("k", 2 * MS, 3 * MS, 0),
           DeviceEvent("k", int(2.5 * MS), 4 * MS, 0),
           DeviceEvent("Memcpy DtoD (Device -> Device)", 6 * MS, 7 * MS, 0),
           DeviceEvent("Memcpy DtoH (Device -> Pageable)", int(7.1 * MS),
                       int(7.2 * MS), 0),
           DeviceEvent("k", 11 * MS, 15 * MS, 0),
           DeviceEvent("Memcpy HtoD (Pageable -> Device)", 19 * MS,
                       int(19.1 * MS), 0),
           DeviceEvent("k", 21 * MS, 30 * MS, 0)]
    sl = Slice(dev, [], cpu, 0, 100 * MS)
    spans = [_span("engine.step.launch", 0.9, 1.6),
             _span("engine.step.launch", 9.9, 10.6),
             _span("engine.admit.launch", 19.9, 20.3)]
    got = S.graph_anatomy(sl, spans)
    step = got["engine.step.launch"]
    assert step["graphs"] == 2
    assert step["span_ms"] == pytest.approx((5 + 4) / 2)
    assert step["busy_ms"] == pytest.approx((3 + 4) / 2)
    assert step["idle_ms"] == pytest.approx((2 + 0) / 2)
    assert step["to_first_ms"] == pytest.approx((1 + 1) / 2)
    assert step["call_ms"] == pytest.approx(0.5)
    assert step["ops"] == pytest.approx((3 + 1) / 2)
    assert step["gap_ms"] == pytest.approx(4.0)
    admit = got["engine.admit.launch"]
    assert admit["graphs"] == 1 and admit["span_ms"] == pytest.approx(9.0)
    assert "gap_ms" not in admit


def test_span_tool_runs_a_tiny_cell_on_the_cpu(monkeypatch):
    """The tool's run: the result line as ``run_cell`` gives it, and the
    host spans of the engine and of its drive loop in the window; no device
    clock on the CPU."""
    monkeypatch.setattr(serve, "WAIT_S", 5)
    spec = importlib.util.spec_from_file_location("engine_spans", TOOL)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    cell = load_cell("tiny-dense.chat_tiny", DATA / "BENCHMARK.json", DATA)
    out, fig = tool.traced_run(cell, 2 ** 31 + 977, 1.5, torch.device("cpu"),
                               time.monotonic(), log=lambda m: None)
    assert out["correct"], out["checks"]
    assert fig["decode_graph_ms"] is None and fig["admit_graph_ms"] is None
    assert fig["step_launch_interval_ms"] > 0
    assert {"engine.step.launch", "engine.step.wait", "engine.step.book",
            "engine.admit.stage", "engine.admit.launch", "replica.take",
            "replica.finish"} <= set(fig["host_spans_ms"])
    assert serve.ServeCell.__name__ == "ServeCell"
