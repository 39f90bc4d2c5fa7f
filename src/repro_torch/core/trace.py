"""Lightweight distributed tracing for the control and serving planes.

The paper's headline numbers are propagation latencies (Figs. 7-8), but in a
running deployment nothing *follows* an object from its tenant-plane write
through the downward shard, the super-cluster commit, and the upward status
sync back into the tenant plane. This module is the span layer that makes
that path observable in situ:

- :class:`Span` — ids/parent/attrs plus monotonic ``start``/``end``; used as
  a context manager for in-flight work, or recorded after the fact from
  already-measured timestamps (:meth:`Tracer.record`) so batch fast lanes
  never pay per-item context-manager overhead.
- :class:`Tracer` — a bounded in-memory ring of finished spans with
  **head-based per-tenant sampling** (the keep/drop decision is made when a
  trace is born and rides its traceparent) plus **always-keep-slow tail
  retention**: a span whose duration crosses ``slow_threshold_s`` is kept
  even when its trace lost the sampling toss, so the outliers the SLO layer
  cares about are never sampled away.
- **traceparent annotations** — trace context crosses process-internal
  planes the same way it crosses real clusters: a W3C-style
  ``00-<trace>-<span>-<flags>`` string in ``metadata.annotations`` under
  :data:`TRACEPARENT_KEY`, injected at the tenant-plane write and carried by
  the syncer's projection (``deepcopy_obj`` keeps annotations) into the
  super commit and back up.
- **pending spans** — the per-object end-to-end propagation span is opened
  at the tenant write (:meth:`Tracer.start_pending`) and closed by whichever
  upward worker lands the first status back
  (:meth:`Tracer.finish_pending`); the registry is bounded and idempotent,
  so status flaps and forgotten objects cannot leak memory.

Context across quanta
---------------------
The cooperative executor multiplexes task quanta over a fixed OS-thread
pool, so a task's quanta hop threads and **thread-locals lie** across a
``Task.WAIT``. The current-span context therefore attaches to ``Task``
objects explicitly: :func:`current_span`/:func:`swap_current` manage a
thread-local *per quantum*, and ``CooperativeExecutor._run_quantum``
installs the task's saved context before ``fn()`` and saves it back after —
a span opened in one quantum is still current in the next, whichever pool
thread runs it.

Tracing off must cost nothing: every instrumentation site guards on
``tracer is not None``, and a disabled deployment simply has no tracer.
"""
from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import OrderedDict, deque
from typing import Any, Deque, Dict, List, Optional, Tuple

# metadata.annotations key carrying trace context across planes
TRACEPARENT_KEY = "vc/traceparent"

_SAMPLED_FLAG = "01"
_UNSAMPLED_FLAG = "00"

# Id generation sits on every hot write path (the store-commit record runs
# under the store lock), so ids are a process-random prefix plus an atomic
# counter — ~10x cheaper than a uuid4 per id, still unique across
# processes. ``next()`` on ``itertools.count`` is atomic in CPython.
_SESSION = uuid.uuid4().hex[:16]
_ids = itertools.count(1)


def _trace_id() -> str:
    return _SESSION + format(next(_ids), "016x")    # 32 hex chars


def _span_id() -> str:
    return format(next(_ids), "016x")               # 16 hex chars


def make_traceparent(trace_id: str, span_id: str, sampled: bool) -> str:
    """W3C-style ``00-<trace>-<span>-<flags>`` carrier string."""
    flag = _SAMPLED_FLAG if sampled else _UNSAMPLED_FLAG
    return f"00-{trace_id}-{span_id}-{flag}"


def parse_traceparent(value: str) -> Optional[Tuple[str, str, bool]]:
    """``(trace_id, span_id, sampled)`` or ``None`` for malformed input."""
    parts = value.split("-")
    if len(parts) != 4 or not parts[1] or not parts[2]:
        return None
    return parts[1], parts[2], parts[3] == _SAMPLED_FLAG


def sampled_carrier(traceparent: str) -> bool:
    """Cheap head-decision peek for hot batch lanes: True when the carried
    flag marks the trace as sampled, without a full parse. An UNSAMPLED
    trace's downward/commit child spans can never be retained (they are
    sub-threshold by construction), so instrumented fast paths skip their
    record calls entirely on this check — the e2e pending span and the
    SLO/histogram feeds are not gated by it."""
    return traceparent.endswith("-" + _SAMPLED_FLAG)


# -- task-attached context -----------------------------------------------------

_tls = threading.local()


def current_span() -> Optional["Span"]:
    """The span installed on THIS thread for the current quantum (or call
    stack, outside the executor)."""
    return getattr(_tls, "span", None)


def swap_current(span: Optional["Span"]) -> Optional["Span"]:
    """Install ``span`` as current and return the previous one. The executor
    calls this around every quantum (install the task's saved context, then
    save it back); ``Span.__enter__``/``close`` use it for nesting."""
    prev = getattr(_tls, "span", None)
    _tls.span = span
    return prev


class Span:
    """One timed operation. ``start``/``end`` are ``time.monotonic``.

    Use as a context manager (installs itself as the current span, restores
    the previous one and reports to the tracer on exit), or hold the object
    and ``close()`` it explicitly — only :meth:`Tracer.start_pending` spans
    are meant to live outside a ``with`` (the lint rule VCL006 enforces
    this for ``start_span``).
    """

    __slots__ = ("tracer", "name", "trace_id", "span_id", "parent_id",
                 "tenant", "sampled", "start", "end", "attrs", "_prev",
                 "_installed")

    def __init__(self, tracer: "Tracer", name: str, *, trace_id: str,
                 span_id: str, parent_id: str = "", tenant: str = "",
                 sampled: bool = True, start: Optional[float] = None,
                 attrs: Optional[Dict[str, Any]] = None):
        self.tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.tenant = tenant
        self.sampled = sampled
        self.start = time.monotonic() if start is None else start
        self.end = 0.0
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self._prev: Optional[Span] = None
        self._installed = False

    @property
    def duration(self) -> float:
        return max(0.0, (self.end or time.monotonic()) - self.start)

    def traceparent(self) -> str:
        return make_traceparent(self.trace_id, self.span_id, self.sampled)

    def set_attr(self, key: str, value: Any) -> "Span":
        self.attrs[key] = value
        return self

    def close(self, end: Optional[float] = None) -> None:
        """Finish the span (idempotent); reports it to the tracer, which
        applies the keep/drop decision."""
        if self.end:
            return
        self.end = time.monotonic() if end is None else end
        if self._installed:
            self._installed = False
            swap_current(self._prev)
            self._prev = None
        self.tracer._finish(self)

    def __enter__(self) -> "Span":
        self._prev = swap_current(self)
        self._installed = True
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "trace_id": self.trace_id,
                "span_id": self.span_id, "parent_id": self.parent_id,
                "tenant": self.tenant, "sampled": self.sampled,
                "start": self.start, "end": self.end,
                "duration_s": max(0.0, self.end - self.start),
                "attrs": dict(self.attrs)}


class Tracer:
    """Bounded span sink: sampling at the head, slow-tail retention, and a
    ring of finished spans served on ``/traces``.

    ``sample`` is the per-tenant head-sampling rate in [0, 1]: each tenant
    keeps a deterministic ``sample`` fraction of its traces (stride
    sampling over a per-tenant trace counter — no RNG, so runs are
    reproducible). A trace that loses the toss still executes all its
    instrumentation; its spans are dropped at finish UNLESS they ran longer
    than ``slow_threshold_s`` (tail retention).
    """

    def __init__(self, *, capacity: int = 8192, sample: float = 1.0,
                 slow_threshold_s: float = 0.25, max_pending: int = 4096):
        self.capacity = max(16, int(capacity))
        self.sample = min(1.0, max(0.0, float(sample)))
        self.slow_threshold_s = float(slow_threshold_s)
        self.max_pending = max(16, int(max_pending))
        self._lock = threading.Lock()
        self._ring: Deque[Dict[str, Any]] = deque(maxlen=self.capacity)
        self._pending: "OrderedDict[str, Span]" = OrderedDict()
        self._tenant_seq: Dict[str, int] = {}
        # counters (read by tests/benchmarks and exported as gauges)
        self.started = 0
        self.kept = 0
        self.dropped_unsampled = 0
        self.kept_slow = 0              # unsampled spans retained by tail rule
        self.pending_evicted = 0

    # -- sampling ----------------------------------------------------------

    def should_sample(self, tenant: str = "") -> bool:
        """Head decision for a NEW trace of ``tenant``: deterministic stride
        sampling over the tenant's trace counter."""
        rate = self.sample
        if rate >= 1.0:
            return True
        if rate <= 0.0:
            return False
        with self._lock:
            seq = self._tenant_seq.get(tenant, 0) + 1
            self._tenant_seq[tenant] = seq
        return int(seq * rate) > int((seq - 1) * rate)

    # -- span creation -----------------------------------------------------

    def start_span(self, name: str, *, tenant: str = "",
                   traceparent: Optional[str] = None,
                   attrs: Optional[Dict[str, Any]] = None) -> Span:
        """Open an in-flight span. MUST be used as a context manager
        (``with tracer.start_span(...) as sp:``) so it is closed on every
        path — vclint rule VCL006 flags anything else. Parent comes from
        ``traceparent`` when given, else from the current task context."""
        if traceparent is not None:
            parsed = parse_traceparent(traceparent)
            if parsed is not None:
                trace_id, parent_id, sampled = parsed
            else:
                trace_id, parent_id, sampled = (
                    _trace_id(), "", self.should_sample(tenant))
        else:
            cur = current_span()
            if cur is not None:
                trace_id, parent_id, sampled = (
                    cur.trace_id, cur.span_id, cur.sampled)
            else:
                trace_id, parent_id = _trace_id(), ""
                sampled = self.should_sample(tenant)
        with self._lock:
            self.started += 1
        return Span(self, name, trace_id=trace_id, span_id=_span_id(),
                    parent_id=parent_id, tenant=tenant, sampled=sampled,
                    attrs=attrs)

    def start_pending(self, name: str, *, tenant: str = "",
                      attrs: Optional[Dict[str, Any]] = None) -> Span:
        """Open a trace ROOT whose close happens in another plane (the
        end-to-end propagation span): registered under its trace id and
        closed later via :meth:`finish_pending`. The registry is bounded —
        past ``max_pending`` open traces the oldest is evicted (dropped,
        counted), so forgotten objects cannot leak spans.

        Head sampling applies here: a head-unsampled root still gets a
        carrier (flag ``00``, so the decision propagates) but is NOT
        registered — the unsampled path costs two counter bumps and a
        string, and its later :meth:`finish_pending` finds nothing. Close-
        side consumers (propagation histograms, SLO feeds) therefore see
        the sampled subset, an unbiased estimator of the population."""
        span = Span(self, name, trace_id=_trace_id(), span_id=_span_id(),
                    tenant=tenant, sampled=self.should_sample(tenant),
                    attrs=attrs)
        with self._lock:
            self.started += 1
            if span.sampled:
                self._pending[span.trace_id] = span
                while len(self._pending) > self.max_pending:
                    self._pending.popitem(last=False)
                    self.pending_evicted += 1
        return span

    def finish_pending(self, ref: str,
                       end: Optional[float] = None) -> Optional[Span]:
        """Close the pending root for ``ref`` (a trace id or a full
        traceparent). Idempotent: the first closer wins, later calls get
        ``None``."""
        trace_id = ref
        if "-" in ref:
            parsed = parse_traceparent(ref)
            if parsed is None:
                return None
            trace_id = parsed[0]
        with self._lock:
            span = self._pending.pop(trace_id, None)
        if span is None:
            return None
        span.close(end)
        return span

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    # -- after-the-fact recording (batch fast lanes) -----------------------

    def record(self, name: str, start: float, end: float, *,
               trace_id: Optional[str] = None, parent_id: str = "",
               tenant: str = "", sampled: Optional[bool] = None,
               keep: Optional[bool] = None,
               attrs: Optional[Dict[str, Any]] = None
               ) -> Optional[Dict[str, Any]]:
        """Record an already-measured interval as a finished span. Returns
        the span dict when kept (callers chain children off its ids), else
        ``None``. ``keep`` overrides the sample/slow decision — pass the
        parent's verdict so a kept trace keeps its whole tree."""
        if sampled is None:
            sampled = self.should_sample(tenant)
        if keep is None:
            keep = sampled or (end - start) >= self.slow_threshold_s
        if not keep:
            with self._lock:
                self.started += 1
                self.dropped_unsampled += 1
            return None
        # build the record outside the lock: this path runs inside hot
        # write lanes (sometimes under the store lock already)
        rec = {"name": name, "trace_id": trace_id or _trace_id(),
               "span_id": _span_id(), "parent_id": parent_id,
               "tenant": tenant, "sampled": sampled,
               "start": start, "end": end,
               "duration_s": max(0.0, end - start),
               "attrs": dict(attrs) if attrs else {}}
        with self._lock:
            self.started += 1
            if not sampled:
                self.kept_slow += 1
            self.kept += 1
            self._ring.append(rec)
        return rec

    def record_from(self, traceparent: str, name: str, start: float,
                    end: float, *, tenant: str = "",
                    attrs: Optional[Dict[str, Any]] = None
                    ) -> Optional[Dict[str, Any]]:
        """``record`` parented from a carried traceparent annotation (the
        syncer/upward/store instrumentation path). Malformed carriers are
        ignored."""
        parsed = parse_traceparent(traceparent)
        if parsed is None:
            return None
        trace_id, parent_id, sampled = parsed
        return self.record(name, start, end, trace_id=trace_id,
                           parent_id=parent_id, tenant=tenant,
                           sampled=sampled, attrs=attrs)

    def _finish(self, span: Span) -> None:
        keep = span.sampled or span.duration >= self.slow_threshold_s
        with self._lock:
            if not keep:
                self.dropped_unsampled += 1
                return
            if not span.sampled:
                self.kept_slow += 1
            self.kept += 1
            self._ring.append(span.as_dict())

    # -- export ------------------------------------------------------------

    def spans(self) -> List[Dict[str, Any]]:
        """Snapshot of the retained ring, oldest first (non-destructive:
        concurrent scrapes each see a consistent copy)."""
        with self._lock:
            return [dict(s) for s in self._ring]

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._pending.clear()

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"started": self.started, "kept": self.kept,
                    "kept_slow": self.kept_slow,
                    "dropped_unsampled": self.dropped_unsampled,
                    "pending": len(self._pending),
                    "pending_evicted": self.pending_evicted,
                    "retained": len(self._ring)}

    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON (Perfetto-loadable): one complete ("X")
        event per span, grouped one trace per tid, timestamps in µs
        relative to the earliest retained span."""
        spans = self.spans()
        if not spans:
            return {"traceEvents": [], "displayTimeUnit": "ms"}
        t0 = min(s["start"] for s in spans)
        tids: Dict[str, int] = {}
        events: List[Dict[str, Any]] = []
        for s in spans:
            tid = tids.get(s["trace_id"])
            if tid is None:
                tid = tids[s["trace_id"]] = len(tids) + 1
                events.append({"ph": "M", "name": "thread_name", "pid": 1,
                               "tid": tid,
                               "args": {"name": f"trace {s['trace_id'][:8]}"
                                        + (f" [{s['tenant']}]"
                                           if s["tenant"] else "")}})
            args = dict(s["attrs"])
            args["span_id"] = s["span_id"]
            if s["parent_id"]:
                args["parent_id"] = s["parent_id"]
            events.append({
                "name": s["name"], "cat": s["tenant"] or "vc", "ph": "X",
                "ts": (s["start"] - t0) * 1e6,
                "dur": max(0.0, s["end"] - s["start"]) * 1e6,
                "pid": 1, "tid": tid, "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


def inject(tracer: Optional[Tracer], obj: Any, span: Span) -> None:
    """Stamp ``span``'s traceparent onto an API object's annotations (the
    tenant-plane write hook). No-op without a tracer."""
    if tracer is None:
        return
    obj.metadata.annotations[TRACEPARENT_KEY] = span.traceparent()


def extract(obj: Any) -> Optional[str]:
    """The traceparent carried by an API object, if any."""
    try:
        return obj.metadata.annotations.get(TRACEPARENT_KEY)
    except AttributeError:
        return None
