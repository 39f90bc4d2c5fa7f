"""Readers of a ``torch.profiler`` trace, from its raw Kineto events.

``trace_events``, ``device_ms_by_name`` and ``node_device_ms`` are copies
of ``chip_smoke.py``'s (held there against ``key_averages`` by
``trace_readers_phase``), which read the events directly because
``prof.events()`` builds a tree of Python objects that took minutes on a
long trace. Device busy time is the union of the device's activity
intervals (``busy_intervals``), not a sum of durations, which counts
twice what two streams run at once.
"""
from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple


@dataclass
class DeviceEvent:
    name: str
    start_ns: int
    end_ns: int
    correlation: int


@dataclass
class HostRange:
    name: str
    start_ns: int
    end_ns: int
    thread: int


def trace_events(prof):
    """A profiler's raw Kineto events, hidden ones left out."""
    return [e for e in prof.profiler.kineto_results.events()
            if not getattr(e, "is_hidden_event", lambda: False)()]


def split(events) -> Tuple[List[DeviceEvent], List[HostRange], list]:
    """(device activities, host ``record_function`` ranges and ops, the
    raw CPU events) of a trace's raw events."""
    from torch.autograd import DeviceType
    dev, host, cpu = [], [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if _annotation(e):
                continue
            start = e.start_ns()
            dev.append(DeviceEvent(e.name(), start, start + e.duration_ns(),
                                   e.linked_correlation_id()))
        elif e.device_type() == DeviceType.CPU:
            cpu.append(e)
            if e.name().startswith("vcbench."):
                host.append(HostRange(e.name(), e.start_ns(), e.end_ns(),
                                      e.start_thread_id()))
    return dev, host, cpu


def _annotation(e) -> bool:
    """A host range mirrored on the device's timeline (a
    ``record_function`` around launches), which is no device work."""
    user = getattr(e, "is_user_annotation", None)
    return e.name().startswith("vcbench.") or bool(user and user())


def device_ms_by_name(dev: Iterable[DeviceEvent]) -> Dict[str, Tuple[int,
                                                                     float]]:
    """{kernel name: (launches, device ms)}."""
    per_name: Dict[str, Tuple[int, float]] = {}
    for e in dev:
        n, t = per_name.get(e.name, (0, 0.0))
        per_name[e.name] = (n + 1, t + (e.end_ns - e.start_ns) / 1e6)
    return per_name


def busy_intervals(dev: Iterable[DeviceEvent]) -> List[Tuple[int, int]]:
    """The union of the device's activity intervals, merged and sorted."""
    merged: List[List[int]] = []
    for lo, hi in sorted((e.start_ns, e.end_ns) for e in dev):
        if merged and lo <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], hi)
        else:
            merged.append([lo, hi])
    return [(lo, hi) for lo, hi in merged]


def busy_ns(intervals: Sequence[Tuple[int, int]], lo: int, hi: int) -> int:
    """Busy nanoseconds of ``intervals`` inside [lo, hi)."""
    return sum(max(0, min(b, hi) - max(a, lo)) for a, b in intervals)


def idle_gaps(intervals: Sequence[Tuple[int, int]], lo: int, hi: int
              ) -> List[Tuple[int, int]]:
    """The gaps of [lo, hi) in which the device ran nothing."""
    gaps, t = [], lo
    for a, b in intervals:
        if b <= lo or a >= hi:
            continue
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if t < hi:
        gaps.append((t, hi))
    return gaps


def labeller(ranges: Sequence[HostRange], default: str):
    """A function from a time to the name of the host range that holds it
    (the ranges do not overlap: one drive thread), else ``default``."""
    rs = sorted(ranges, key=lambda r: r.start_ns)
    starts = [r.start_ns for r in rs]

    def label(t_ns: int) -> str:
        i = bisect_right(starts, t_ns) - 1
        if i >= 0 and t_ns < rs[i].end_ns:
            return rs[i].name.split(".", 1)[1]
        return default
    return label


def node_device_ms(cpu_events, dev: Sequence[DeviceEvent],
                   nodes: Sequence[str]) -> Dict[str, float]:
    """{node: device ms} of the kernels launched inside each autograd node
    whose name holds ``node``: a kernel belongs to the CPU op that launched
    it (its correlation id), and an op to a node when it starts inside the
    node's time range on the node's thread (copy of ``chip_smoke.py``'s)."""
    kernel_ns: Dict[int, int] = {}
    for e in dev:
        kernel_ns[e.correlation] = kernel_ns.get(e.correlation, 0) \
            + (e.end_ns - e.start_ns)
    ops = []
    ranges: Dict[str, Dict[int, list]] = {node: {} for node in nodes}
    for e in cpu_events:
        if not e.is_async() and e.linked_correlation_id() == 0:
            thread = e.start_thread_id()
            ops.append((e.correlation_id(), thread, e.start_ns()))
            for node in nodes:
                if node in e.name():
                    ranges[node].setdefault(thread, []).append(
                        (e.start_ns(), e.end_ns()))
    out = {}
    for node, by_thread in ranges.items():
        merged = {}
        for thread, spans in by_thread.items():
            m: List[List[int]] = []
            for lo, hi in sorted(spans):      # nested spans: keep the outer
                if m and lo <= m[-1][1]:
                    m[-1][1] = max(m[-1][1], hi)
                else:
                    m.append([lo, hi])
            merged[thread] = ([lo for lo, _ in m], m)
        ns = 0
        for cid, thread, start in ops:
            if cid in kernel_ns and thread in merged:
                starts, m = merged[thread]
                i = bisect_right(starts, start) - 1
                if i >= 0 and start <= m[i][1]:
                    ns += kernel_ns[cid]
        out[node] = ns / 1e6
    return out


@dataclass
class Slice:
    """What one profiled slice of a run holds."""
    dev: List[DeviceEvent]
    host: List[HostRange]
    cpu: list
    lo_ns: int
    hi_ns: int

    @property
    def window_s(self) -> float:
        return (self.hi_ns - self.lo_ns) / 1e9

    def intervals(self):
        return busy_intervals(self.dev)

    def busy_s(self) -> float:
        return busy_ns(self.intervals(), self.lo_ns, self.hi_ns) / 1e9

    def kernel_s(self, match: str) -> float:
        return sum(e.end_ns - e.start_ns for e in self.dev
                   if match in e.name) / 1e9

    def breakdown(self, default: str) -> Dict[str, list]:
        """The top device operations by time, and the longest idle gaps
        named by the host range they fell in (``default`` outside any)."""
        per = device_ms_by_name(self.dev)
        ops = sorted(per.items(), key=lambda kv: -kv[1][1])[:10]
        gaps = idle_gaps(self.intervals(), self.lo_ns, self.hi_ns)
        totals: Dict[str, float] = {}
        named = []
        label_of = labeller(self.host, default)
        for a, b in gaps:
            label = label_of((a + b) // 2)
            totals[label] = totals.get(label, 0.0) + (b - a) / 1e9
            named.append((label, (b - a) / 1e9))
        named.sort(key=lambda x: -x[1])
        entries = [[f"all gaps in {k}", v] for k, v in
                   sorted(totals.items(), key=lambda kv: -kv[1])][:4]
        entries += [[f"gap in {k}", v] for k, v in named[:10 - len(entries)]]
        return {"device_ops": [[name[:120], ms / 1e3]
                               for name, (_, ms) in ops],
                "idle_gaps": entries}


def profile_slice(prof, mark_mono_ns: int,
                  spans: Sequence[Tuple[str, int, int]]) -> Slice:
    """The slice a finished profiler recorded, between the start and the
    end of its ``vcbench.slice`` range. That range was entered at host
    time ``mark_mono_ns`` (``time.monotonic_ns``), which places the
    profiler's clock against the host's: ``spans`` (name, start, end in
    ``monotonic_ns``), the benchmark's host spans, are moved onto the
    profiler's clock to name the idle gaps."""
    dev, host, cpu = split(trace_events(prof))
    marks = [r for r in host if r.name == "vcbench.slice"]
    if not marks:
        raise RuntimeError("the profiled slice has no vcbench.slice range")
    lo_ns, hi_ns = marks[0].start_ns, marks[-1].end_ns
    dev = [e for e in dev if lo_ns <= e.start_ns < hi_ns]
    off = lo_ns - mark_mono_ns
    ranges = [HostRange(f"vcbench.{name}", a + off, b + off, 0)
              for name, a, b in spans if b + off > lo_ns and a + off < hi_ns]
    return Slice(dev, ranges, cpu, lo_ns, hi_ns)
