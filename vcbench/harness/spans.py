"""Readers of the serving engine's own spans: the span lane of
``repro_torch.core.trace.Tracer`` that a traced engine
(``GenerationEngine.tracer``) and its drive loop fill, beside the profiled
slice of the same run.

The lane holds host spans (``time.monotonic`` seconds):
``engine.step.launch`` / ``.wait`` / ``.book``, ``engine.admit.stage`` /
``.launch`` / ``.wait`` / ``.book`` / ``.capture``, ``replica.take`` /
``.finish`` / ``.park``; and device durations from CUDA events (totals
only): ``engine.step.device``, ``engine.admit.device``,
``engine.step.gap``. Here a device duration is a ``Reading`` (the host
time it was taken at, right after its call's sync), so that a window's
durations can be chosen by time. Host spans go onto the profiler's clock
by the offset that ``kineto.profile_slice`` takes from the
``vcbench.slice`` mark (``Slice.lo_ns`` minus the mark's
``monotonic_ns``), and then by the shift that puts the program's graph
launches around the profiler's ``cudaGraphLaunch`` calls
(``launch_shift_ns``): on the card the mark's range and the runtime calls
stood up to 0.18 ms apart.
"""
from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .kineto import Slice, busy_intervals, idle_gaps

LAUNCHES = ("engine.step.launch", "engine.admit.launch")
PARK = "replica.park"


@dataclass
class Reading:
    at: float                   # time.monotonic when it was read
    name: str
    seconds: float


@dataclass
class Span:
    name: str
    start_ns: int               # the profiler's clock
    end_ns: int


def _mean_ms(values: Sequence[float]) -> Optional[float]:
    return 1e3 * sum(values) / len(values) if values else None


def device_ms(readings: Iterable[Reading], name: str, lo: float,
              hi: float) -> Optional[float]:
    """Mean of the ``name`` durations read in [lo, hi) (monotonic
    seconds), in ms; None without any."""
    return _mean_ms([r.seconds for r in readings
                     if r.name == name and lo <= r.at < hi])


def span_ms(records, name: str, lo: float, hi: float) -> Optional[float]:
    """Mean length of the lane's ``name`` spans that ended in [lo, hi), in
    ms."""
    return _mean_ms([e - s for n, s, e, _ in records
                     if n == name and lo <= e < hi])


def launch_interval_ms(records, lo: float, hi: float) -> Optional[float]:
    """Mean interval between the starts of consecutive
    ``engine.step.launch`` spans with no ``engine.admit.launch`` between
    them, over the pairs whose second step ended in [lo, hi): the host's
    side of a step graph plus the device's gap after it."""
    gaps, prev = [], None
    for name, start, _, _ in sorted(
            (r for r in records if r[0] in LAUNCHES), key=lambda r: r[1]):
        if name == "engine.admit.launch":
            prev = None
            continue
        if prev is not None:
            gaps.append((start, start - prev))
        prev = start
    ends = sorted(e for n, _, e, _ in records if n == "engine.step.book")
    chosen = []
    for start, dt in gaps:            # the step's end: its book span's
        i = bisect_right(ends, start)
        if i < len(ends) and lo <= ends[i] < hi:
            chosen.append(dt)
    return _mean_ms(chosen)


def on_profiler_clock(records, offset_ns: int, lo_ns: int,
                      hi_ns: int) -> List[Span]:
    """The lane's spans that reach into [lo_ns, hi_ns) of the profiler's
    clock, moved there by ``offset_ns``, sorted by start."""
    out = []
    for name, s, e, _ in records:
        a, b = round(s * 1e9) + offset_ns, round(e * 1e9) + offset_ns
        if b > lo_ns and a < hi_ns:
            out.append(Span(name, a, b))
    out.sort(key=lambda x: x.start_ns)
    return out


def sync_wake_ms(sl: Slice, spans: Sequence[Span]) -> Optional[float]:
    """Mean, over the slice's ``engine.step.wait`` spans, of the span's end
    minus the end of the step's device-to-host copy (the last ``Memcpy
    DtoH`` that ended inside the span): how long the drive thread took to
    come back after the device had finished, the GIL included. Waits with
    no copy in them are left out."""
    ends = sorted(e.end_ns for e in sl.dev if "DtoH" in e.name)
    wakes = []
    for s in spans:
        if s.name != "engine.step.wait" or s.start_ns < sl.lo_ns \
                or s.end_ns > sl.hi_ns:
            continue
        i = bisect_right(ends, s.end_ns) - 1
        if i >= 0 and ends[i] >= s.start_ns:
            wakes.append((s.end_ns - ends[i]) / 1e9)
    return _mean_ms(wakes)


def _category(name: str) -> str:
    if name.endswith(".wait"):
        return "wait"
    if name == PARK:
        return "parked_or_outside"
    return "host"


def idle_split(sl: Slice, spans: Sequence[Span]) -> Dict[str, float]:
    """The slice's idle seconds split by what the drive thread was doing
    meanwhile: in a ``*.wait`` span (``wait``), in another span of the
    program but ``replica.park`` (``host``: the idle time that host work
    explains), parked or in no span (``parked_or_outside``). The spans of
    one drive thread do not overlap; where they would, the earlier wins."""
    out = {"wait": 0.0, "host": 0.0, "parked_or_outside": 0.0}
    starts = [s.start_ns for s in spans]
    for a, b in idle_gaps(sl.intervals(), sl.lo_ns, sl.hi_ns):
        t = a
        i = max(0, bisect_right(starts, a) - 1)
        while t < b and i < len(spans):
            s = spans[i]
            i += 1
            if s.end_ns <= t:
                continue
            if s.start_ns >= b:
                break
            lo, hi = max(t, s.start_ns), min(b, s.end_ns)
            out["parked_or_outside"] += max(0, lo - t) / 1e9
            out[_category(s.name)] += max(0, hi - lo) / 1e9
            t = max(t, hi)
        out["parked_or_outside"] += max(0, b - t) / 1e9
    return out


def _graph_launches(sl: Slice) -> list:
    """The slice's ``cudaGraphLaunch`` runtime calls, by start."""
    return sorted((e for e in sl.cpu if e.name().startswith("cudaGraphLaunch")
                   and sl.lo_ns <= e.start_ns() < sl.hi_ns),
                  key=lambda e: e.start_ns())


def _nearest(launch: Sequence[Span], starts: Sequence[int], a: int,
             b: int) -> Tuple[Optional[Span], int]:
    """The span of ``launch`` (sorted, with their ``starts``) nearest to
    the interval [a, b], and how far [a, b] lies outside it."""
    best, miss = None, 0
    i = bisect_right(starts, a)
    for s in launch[max(0, i - 1):i + 1]:
        d = max(0, s.start_ns - a, b - s.end_ns)
        if best is None or d < miss:
            best, miss = s, d
    return best, miss


def launch_shift_ns(sl: Slice, spans: Sequence[Span]) -> Optional[int]:
    """The shift of the program's spans that puts every ``cudaGraphLaunch``
    call of the slice inside the ``engine.step.launch`` or
    ``engine.admit.launch`` span nearest it: the middle of the shifts that
    do (or, where none does, of those that come nearest). The profiler's
    runtime calls and device work share one clock, its ``record_function``
    ranges (the ``vcbench.slice`` mark) can stand apart from it."""
    launch = [s for s in spans if s.name in LAUNCHES]
    starts = [s.start_ns for s in launch]
    lo, hi = None, None
    for e in _graph_launches(sl):
        s, _ = _nearest(launch, starts, e.start_ns(), e.end_ns())
        if s is None:
            continue
        lo = e.end_ns() - s.end_ns if lo is None else max(
            lo, e.end_ns() - s.end_ns)
        hi = e.start_ns() - s.start_ns if hi is None else min(
            hi, e.start_ns() - s.start_ns)
    return None if lo is None else (lo + hi) // 2


def graph_launch_residual_us(sl: Slice, spans: Sequence[Span]
                             ) -> Tuple[int, Optional[float]]:
    """(how many ``cudaGraphLaunch`` runtime calls the slice holds, the
    largest distance in µs by which one of them lies outside every
    ``engine.step.launch`` / ``engine.admit.launch`` span): 0 where the
    two clocks agree."""
    launch = [s for s in spans if s.name in LAUNCHES]
    starts = [s.start_ns for s in launch]
    worst, n = None, 0
    for e in _graph_launches(sl):
        n += 1
        s, miss = _nearest(launch, starts, e.start_ns(), e.end_ns())
        if s is not None:
            worst = miss if worst is None else max(worst, miss)
    return n, (None if worst is None else worst / 1e3)


def graph_anatomy(sl: Slice, spans: Sequence[Span]) -> Dict[str, Dict]:
    """Each graph replay of the slice, from the profiler's own clock: its
    ``cudaGraphLaunch`` call and the device work that started between it
    and the next launch call, copies to and from the host left out (every
    call of the engine syncs before the next is launched, so that work is
    the graph's). By the launch span that holds the call (step or
    admission), the means of: the call's host time (``call_ms``), from the
    call's start to the first kernel (``to_first_ms``), from the first
    kernel's start to the last one's end (``span_ms``), the device busy
    inside it (``busy_ms``: the union of its work) and idle (``idle_ms``),
    its kernels and copies (``ops``); for steps also the device's idle from
    one step graph's last kernel to the next one's first, for consecutive
    steps with no admission between (``gap_ms``)."""
    calls = _graph_launches(sl)
    dev = sorted((e for e in sl.dev if "HtoD" not in e.name
                  and "DtoH" not in e.name), key=lambda e: e.start_ns)
    dev_starts = [e.start_ns for e in dev]
    launch = [s for s in spans if s.name in LAUNCHES]
    starts = [s.start_ns for s in launch]
    rows: Dict[str, List[Dict[str, float]]] = {}
    gaps, prev = [], None
    for i, e in enumerate(calls):
        until = calls[i + 1].start_ns() if i + 1 < len(calls) else sl.hi_ns
        work = dev[bisect_right(dev_starts, e.start_ns() - 1):
                   bisect_right(dev_starts, until - 1)]
        s, _ = _nearest(launch, starts, e.start_ns(), e.end_ns())
        if not work or s is None:
            prev = None
            continue
        first = work[0].start_ns
        last = max(k.end_ns for k in work)
        busy = sum(b - a for a, b in busy_intervals(work))
        rows.setdefault(s.name, []).append({
            "call_ms": (e.end_ns() - e.start_ns()) / 1e6,
            "to_first_ms": (first - e.start_ns()) / 1e6,
            "span_ms": (last - first) / 1e6, "busy_ms": busy / 1e6,
            "idle_ms": (last - first - busy) / 1e6,
            "ops": float(len(work))})
        if s.name == "engine.step.launch":
            if prev is not None:
                gaps.append((first - prev) / 1e6)
            prev = last
        else:
            prev = None
    out = {}
    for name, rs in rows.items():
        out[name] = {k: sum(r[k] for r in rs) / len(rs) for k in rs[0]}
        out[name]["graphs"] = len(rs)
    if gaps and "engine.step.launch" in out:
        out["engine.step.launch"]["gap_ms"] = sum(gaps) / len(gaps)
    return out


def figures(readings: Sequence[Reading], records,
            window: Tuple[float, float], sl: Optional[Slice],
            slice_mono: Optional[Tuple[int, int]]) -> Dict:
    """Everything the engine's spans say of one traced serving run: the
    window before the slice, ``window`` in monotonic seconds, and the slice
    (``slice_mono``: its ends in ``monotonic_ns``), the spans moved onto
    the profiler's clock by the mark's offset and then by
    ``launch_shift_ns``."""
    lo, hi = window
    out: Dict = {
        "decode_graph_ms": device_ms(readings, "engine.step.device", lo, hi),
        "decode_gap_ms": device_ms(readings, "engine.step.gap", lo, hi),
        "admit_graph_ms": device_ms(readings, "engine.admit.device", lo, hi),
        "step_launch_interval_ms": launch_interval_ms(records, lo, hi),
        "host_spans_ms": {
            name: span_ms(records, name, lo, hi) for name in sorted(
                {r[0] for r in records})},
    }
    graph, gap = out["decode_graph_ms"], out["decode_gap_ms"]
    interval = out["step_launch_interval_ms"]
    if None not in (graph, gap, interval):
        out["graph_plus_gap_over_interval"] = (graph + gap) / interval
    if sl is None or slice_mono is None:
        return out
    s_lo, s_hi = slice_mono[0] / 1e9, slice_mono[1] / 1e9
    mark_offset = sl.lo_ns - slice_mono[0]
    shift = launch_shift_ns(sl, on_profiler_clock(records, mark_offset,
                                                  sl.lo_ns, sl.hi_ns)) or 0
    spans = on_profiler_clock(records, mark_offset + shift, sl.lo_ns,
                              sl.hi_ns)
    split = idle_split(sl, spans)
    window_s = sl.window_s
    idle = 100.0 * (1.0 - sl.busy_s() / window_s)
    n_launch, residual = graph_launch_residual_us(sl, spans)
    out.update({
        "sync_wake_ms": sync_wake_ms(sl, spans),
        "idle_host.serve": 100.0 * split["host"] / window_s,
        "idle_split_pct": {k: 100.0 * v / window_s for k, v in split.items()},
        "device_idle_pct": idle,
        "split_sum_minus_idle_pct": 100.0 * sum(split.values()) / window_s
        - idle,
        "graph_launches_in_slice": n_launch,
        "launch_shift_us": shift / 1e3,
        "graph_launch_residual_us": residual,
        "graph_launch_residual_us_at_mark": graph_launch_residual_us(
            sl, on_profiler_clock(records, mark_offset, sl.lo_ns,
                                  sl.hi_ns))[1],
        "slice": {
            "decode_graph_ms": device_ms(readings, "engine.step.device",
                                         s_lo, s_hi),
            "decode_gap_ms": device_ms(readings, "engine.step.gap", s_lo,
                                       s_hi),
            "step_launch_interval_ms": launch_interval_ms(records, s_lo,
                                                          s_hi),
            "host_spans_ms": {
                name: span_ms(records, name, s_lo, s_hi) for name in sorted(
                    {r[0] for r in records})},
            "graphs": graph_anatomy(sl, spans)},
    })
    return out
