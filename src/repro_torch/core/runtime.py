"""Unified controller runtime: one reconciler engine for the whole control
plane (paper §III-C, Fig.3/5).

Every VirtualCluster controller shares one architecture — informers feed a
keyed work queue, rate-limited workers call ``reconcile(key)``, and an
optional periodic scan remediates rare inconsistencies. This module extracts
that machinery once so the syncer, scheduler, router, tenant operator, and
node agents declare only *what* they reconcile, not threads or lifecycle:

- ``Controller``   — declared informers + a work queue (plain, delaying, or
  per-tenant fair) + a ``reconcile(key)`` callback with per-key
  exponential-backoff retries + an optional periodic ``scan()``;
- ``ControllerManager`` — start/stop lifecycle in dependency order, health
  checks, and a process-wide ``MetricsRegistry``;
- ``MetricsRegistry``   — counters, latency summaries, and live gauges
  (queue depth, reconcile latency, retries, scan cost) shared by every
  controller in the process.

Two scheduling modes, switched by the ``executor`` attribute (set directly
or adopted from the :class:`ControllerManager`):

- **cooperative** (executor set): informer pumps, reconcile workers, and the
  periodic scan are tasks on a shared
  :class:`~repro_torch.core.executor.CooperativeExecutor` — thread count is
  O(pool size) regardless of controller/worker/informer count, and delayed
  retries ride the executor's single timer wheel;
- **blocking fallback** (executor ``None``): the legacy one-thread-per-
  worker/informer/scan mode, kept so the two paths stay bisectable.
"""
from __future__ import annotations

import threading
import time
from bisect import bisect_right
from typing import (Any, Callable, Dict, Hashable, List, Optional, Tuple,
                    Type)

from .apiserver import APIServer
from .executor import CooperativeExecutor, RetryLater, Task
from .fairqueue import FairWorkQueue
from .informer import Informer
from .workqueue import DelayingQueue, RateLimiter, WorkQueue

# RetryLater is re-exported here for the existing import surface (agent.py,
# syncer.py, tests); the class itself moved to executor.py so leaf modules
# (apiserver.py) can raise it without importing the controller runtime.
__all__ = ["RetryLater", "MetricsRegistry", "Histogram", "Controller",
           "ControllerManager", "prometheus_text",
           "PROMETHEUS_CONTENT_TYPE"]


# --------------------------------------------------------------------- metrics

class Histogram:
    """Log-spaced latency histogram: mergeable, with exact-ish percentiles.

    ``bounds[i] = start * factor**i`` — the defaults span 100µs to ~14min in
    24 buckets, fine enough that p50/p90/p99 land within one factor-of-2
    bucket of truth (log-linear interpolation inside the bucket tightens
    that further). Unlike the ``[sum, count, max]`` summaries, a histogram
    answers percentile queries over its whole lifetime in O(buckets) and
    two histograms with the same bounds merge by adding counts (per-tenant
    series roll up into fleet-wide ones).

    Self-locking: ``observe`` takes only the histogram's own lock, never the
    registry lock, so the hot path can't contend with ``snapshot()``.
    """

    __slots__ = ("bounds", "counts", "sum", "count", "max", "_lock")

    def __init__(self, *, start: float = 1e-4, factor: float = 2.0,
                 buckets: int = 24,
                 bounds: Optional[Tuple[float, ...]] = None):
        if bounds is not None:
            self.bounds = tuple(bounds)
        else:
            self.bounds = tuple(start * factor ** i for i in range(buckets))
        self.counts = [0] * (len(self.bounds) + 1)   # last = overflow
        self.sum = 0.0
        self.count = 0
        self.max = 0.0
        self._lock = threading.Lock()

    def observe(self, value: float, n: int = 1) -> None:
        if n <= 0:
            return
        idx = bisect_right(self.bounds, value)
        with self._lock:
            self.counts[idx] += n
            self.sum += value * n
            self.count += n
            if value > self.max:
                self.max = value

    def merge(self, other: "Histogram") -> None:
        """Add ``other``'s counts into this histogram (same bounds only)."""
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bounds")
        with other._lock:
            counts = list(other.counts)
            osum, ocount, omax = other.sum, other.count, other.max
        with self._lock:
            for i, c in enumerate(counts):
                self.counts[i] += c
            self.sum += osum
            self.count += ocount
            if omax > self.max:
                self.max = omax

    def percentile(self, p: float) -> float:
        """Estimate the ``p``-th percentile (0-100) by cumulative walk with
        log-linear interpolation inside the landing bucket."""
        with self._lock:
            total = self.count
            counts = list(self.counts)
            hi = self.max
        if total == 0:
            return 0.0
        rank = max(1.0, (min(100.0, max(0.0, p)) / 100.0) * total)
        cum = 0
        for i, c in enumerate(counts):
            if c == 0:
                continue
            if cum + c >= rank:
                frac = (rank - cum) / c
                if i == 0:
                    lo_b, hi_b = 0.0, self.bounds[0]
                    return lo_b + frac * (hi_b - lo_b)
                if i == len(self.bounds):
                    # overflow bucket: bounded above by the observed max
                    lo_b = self.bounds[-1]
                    return lo_b + frac * (max(hi, lo_b) - lo_b)
                lo_b, hi_b = self.bounds[i - 1], self.bounds[i]
                # log-linear: latency mass is multiplicative within a bucket
                return lo_b * (hi_b / lo_b) ** frac
            cum += c
        return hi

    def state(self) -> Dict[str, float]:
        with self._lock:
            count, total, mx = self.count, self.sum, self.max
        return {"count": float(count), "sum": total,
                "mean": total / count if count else 0.0, "max": mx,
                "p50": self.percentile(50.0), "p90": self.percentile(90.0),
                "p99": self.percentile(99.0)}

class MetricsRegistry:
    """Process-wide controller metrics: counters, summaries, gauges.

    Keys are ``name`` plus sorted ``{label=value}`` pairs, Prometheus-style
    (``reconcile_total{controller=scheduler}``). Gauges are callables
    evaluated at snapshot time (e.g. live queue depth).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._summaries: Dict[str, List[float]] = {}   # [sum, count, max]
        self._gauges: Dict[str, Callable[[], float]] = {}
        self._hists: Dict[str, Histogram] = {}
        self.gauge_errors = 0   # snapshot() gauge callables that raised

    @staticmethod
    def _key(name: str, labels: Dict[str, Any]) -> str:
        if not labels:
            return name
        inner = ",".join(f"{k}={v}" for k, v in sorted(labels.items()))
        return f"{name}{{{inner}}}"

    def inc(self, name: str, value: float = 1.0, **labels: Any) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def observe(self, name: str, value: float, **labels: Any) -> None:
        key = self._key(name, labels)
        with self._lock:
            s = self._summaries.setdefault(key, [0.0, 0.0, 0.0])
            s[0] += value
            s[1] += 1
            s[2] = max(s[2], value)

    def observe_n(self, name: str, value: float, n: int = 1,
                  **labels: Any) -> None:
        """``n`` observations of ``value`` in ONE lock round (batch-path
        accounting: per-item summary semantics without per-item locking)."""
        if n <= 0:
            return
        key = self._key(name, labels)
        with self._lock:
            s = self._summaries.setdefault(key, [0.0, 0.0, 0.0])
            s[0] += value * n
            s[1] += n
            s[2] = max(s[2], value)

    def register_gauge(self, name: str, fn: Callable[[], float],
                       **labels: Any) -> None:
        key = self._key(name, labels)
        with self._lock:
            self._gauges[key] = fn

    def histogram(self, name: str, **labels: Any) -> Histogram:
        """Get-or-create the named histogram. The registry lock covers only
        the lookup; the returned histogram self-locks its observes, so hot
        paths should hold onto the reference."""
        key = self._key(name, labels)
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                h = self._hists[key] = Histogram()
        return h

    def counter(self, name: str, **labels: Any) -> float:
        with self._lock:
            return self._counters.get(self._key(name, labels), 0.0)

    def summary(self, name: str, **labels: Any) -> Dict[str, float]:
        with self._lock:
            s = self._summaries.get(self._key(name, labels))
        if s is None:
            return {"sum": 0.0, "count": 0.0, "mean": 0.0, "max": 0.0}
        return {"sum": s[0], "count": s[1],
                "mean": s[0] / s[1] if s[1] else 0.0, "max": s[2]}

    def snapshot(self) -> Dict[str, Any]:
        # hold the registry lock only long enough to copy raw state; summary
        # shaping, gauge callables (which may be arbitrarily slow), and
        # histogram percentile walks all run outside it, so a stalled gauge
        # cannot block every inc()/observe() on the hot path
        with self._lock:
            counters = dict(self._counters)
            raw_summaries = {k: tuple(s) for k, s in self._summaries.items()}
            gauges = list(self._gauges.items())
            hists = list(self._hists.items())
        summaries = {k: {"sum": s[0], "count": s[1],
                         "mean": s[0] / s[1] if s[1] else 0.0,
                         "max": s[2]}
                     for k, s in raw_summaries.items()}
        out_gauges: Dict[str, float] = {}
        errors = 0
        for key, fn in gauges:
            try:
                out_gauges[key] = float(fn())
            except Exception:
                # a broken gauge must not break /metrics, but it must be
                # visible: NaN in the scrape plus an error counter
                errors += 1
                out_gauges[key] = float("nan")
        if errors:
            with self._lock:
                self.gauge_errors += errors
        return {"counters": counters, "summaries": summaries,
                "gauges": out_gauges,
                "histograms": {k: h.state() for k, h in hists}}


# ------------------------------------------------- Prometheus text exposition

#: Content type of the rendered exposition (text format 0.0.4).
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if (ch.isalnum() or ch in "_:") else "_")
    s = "".join(out)
    return s if s and not s[0].isdigit() else "_" + s


def _prom_parse_key(key: str) -> Tuple[str, List[Tuple[str, str]]]:
    """Split a registry key ``name{a=b,c=d}`` into (name, label pairs).
    Label values in this codebase never contain ``,``/``=`` (tenant,
    controller, and informer names), so the flat split is exact."""
    name, brace, rest = key.partition("{")
    labels: List[Tuple[str, str]] = []
    if brace:
        for pair in rest.rstrip("}").split(","):
            k, _, v = pair.partition("=")
            labels.append((k, v))
    return _prom_name(name), labels


def _prom_sample(name: str, labels: List[Tuple[str, str]],
                 value: Any) -> str:
    v = float(value)
    val = "NaN" if v != v else repr(v)
    if not labels:
        return f"{name} {val}"
    inner = ",".join(
        '{}="{}"'.format(_prom_name(k),
                         str(v2).replace("\\", "\\\\").replace('"', '\\"')
                         .replace("\n", "\\n"))
        for k, v2 in labels)
    return f"{name}{{{inner}}} {val}"


def prometheus_text(snapshot: Dict[str, Any]) -> str:
    """Render a :meth:`MetricsRegistry.snapshot` in Prometheus text
    exposition format (0.0.4), for standard scrapers.

    Counters and gauges map 1:1. Summaries render as ``TYPE summary``
    (``<name>_sum``/``<name>_count``), histograms as quantile summaries
    under the ``<name>_hist`` family — a histogram may share its base name
    with a summary (e.g. ``serving_ttft_seconds``), so the suffix keeps
    the two families distinct. ``max`` fields land in trailing
    ``*_max`` gauge families.
    """
    lines: List[str] = []
    max_families: Dict[str, List[Tuple[List[Tuple[str, str]], float]]] = {}

    def grouped(section: Dict[str, Any]
                ) -> List[Tuple[str, List[Tuple[List[Tuple[str, str]], Any]]]]:
        groups: Dict[str, List[Tuple[List[Tuple[str, str]], Any]]] = {}
        for key, val in section.items():
            name, labels = _prom_parse_key(key)
            groups.setdefault(name, []).append((labels, val))
        return [(n, sorted(groups[n], key=lambda e: e[0]))
                for n in sorted(groups)]

    for mtype, section_name in (("counter", "counters"),
                                ("gauge", "gauges")):
        for name, entries in grouped(snapshot.get(section_name, {})):
            lines.append(f"# TYPE {name} {mtype}")
            for labels, val in entries:
                lines.append(_prom_sample(name, labels, val))
    for name, entries in grouped(snapshot.get("summaries", {})):
        lines.append(f"# TYPE {name} summary")
        for labels, s in entries:
            lines.append(_prom_sample(name + "_sum", labels, s.get("sum", 0.0)))
            lines.append(_prom_sample(name + "_count", labels,
                                      s.get("count", 0.0)))
            max_families.setdefault(name + "_max", []).append(
                (labels, float(s.get("max", 0.0))))
    for name, entries in grouped(snapshot.get("histograms", {})):
        fam = name + "_hist"
        lines.append(f"# TYPE {fam} summary")
        for labels, h in entries:
            for q, field in (("0.5", "p50"), ("0.9", "p90"), ("0.99", "p99")):
                lines.append(_prom_sample(
                    fam, labels + [("quantile", q)], h.get(field, 0.0)))
            lines.append(_prom_sample(fam + "_sum", labels, h.get("sum", 0.0)))
            lines.append(_prom_sample(fam + "_count", labels,
                                      h.get("count", 0.0)))
            max_families.setdefault(fam + "_max", []).append(
                (labels, float(h.get("max", 0.0))))
    for name in sorted(max_families):
        lines.append(f"# TYPE {name} gauge")
        for labels, val in sorted(max_families[name], key=lambda e: e[0]):
            lines.append(_prom_sample(name, labels, val))
    return "\n".join(lines) + "\n"


# ------------------------------------------------------------------ controller

AnyQueue = Any   # WorkQueue | DelayingQueue | FairWorkQueue | None


class Controller:
    """One reconciler: informers -> keyed work queue -> workers -> reconcile.

    Subclasses declare informers via :meth:`add_informer` (usually in
    ``__init__``; also valid at runtime — e.g. tenant registration), override
    :meth:`reconcile` (and optionally :meth:`scan`, :meth:`on_start`,
    :meth:`on_stop`), and pick a queue flavour:

    - ``WorkQueue``      — dedup FIFO;
    - ``DelayingQueue``  — dedup FIFO + delayed (rate-limited) retries;
    - ``FairWorkQueue``  — per-tenant sub-queues + WRR dispatch; items are
      ``(tenant, key)`` tuples and retries re-enter the tenant sub-queue.

    Error policy: exceptions from ``reconcile`` matching ``drop_on`` are
    forgotten; those matching ``retry_on`` are requeued with per-key
    exponential backoff (until ``max_retries``); anything else is counted as
    ``reconcile_errors`` and dropped. Workers never die on reconcile errors.
    """

    def __init__(self, name: str, *, queue: AnyQueue = None, workers: int = 1,
                 scan_interval: float = 0.0, batch_size: int = 1,
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                 drop_on: Tuple[Type[BaseException], ...] = (),
                 max_retries: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None):
        self.name = name
        self.queue = queue
        self.workers = workers
        self.scan_interval = scan_interval
        self.batch_size = max(1, batch_size)
        self.retry_on = retry_on
        self.drop_on = drop_on
        self.max_retries = max_retries
        self.metrics = metrics or MetricsRegistry()
        self.limiter = RateLimiter()
        self.executor: Optional[CooperativeExecutor] = None
        self._informers: List[Informer] = []
        self._threads: List[threading.Thread] = []
        self._tasks: List[Task] = []
        self._stop = threading.Event()
        self._running = False
        self._scan_failing = False
        self._lifecycle_lock = threading.Lock()

    # -- declaration -------------------------------------------------------

    def add_informer(self, api: APIServer, kind: str,
                     handler: Optional[Callable[[str, Any], None]] = None,
                     name: str = "", namespace: Optional[str] = None
                     ) -> Informer:
        """Declare (and, if already running, start + sync) an informer."""
        inf = Informer(api, kind, namespace=namespace,
                       name=name or f"{self.name}/{kind}")
        if handler is not None:
            inf.add_handler(handler)
        with self._lifecycle_lock:
            self._informers.append(inf)
            running = self._running
        if running:
            inf.start(executor=self.executor)
            self._sync_unless_pooled(inf)
        return inf

    def remove_informer(self, inf: Informer) -> None:
        with self._lifecycle_lock:
            if inf in self._informers:
                self._informers.remove(inf)
        inf.stop()

    def detach_informer(self, inf: Informer) -> None:
        """Release an informer from this controller WITHOUT stopping it
        (live shard migration: the reflector keeps streaming throughout)."""
        with self._lifecycle_lock:
            if inf in self._informers:
                self._informers.remove(inf)

    def attach_informer(self, inf: Informer) -> None:
        """Adopt a (possibly already-running) informer into this controller's
        lifecycle; started here if the controller runs and it isn't yet."""
        with self._lifecycle_lock:
            self._informers.append(inf)
            running = self._running
        if running and not inf.alive:
            inf.start(executor=self.executor)
            self._sync_unless_pooled(inf)

    def _sync_unless_pooled(self, inf: Informer) -> None:
        """Block until the informer cache syncs — unless we're ON a pool
        thread, where blocking could starve the very pump task we're
        waiting for (self-deadlock at pool_size=1, a parked thread per
        registration otherwise). Reconcilers tolerate a not-yet-synced
        cache: missing informer state retries (``RetryLater``) and the
        initial replay re-delivers every key once the snapshot lands."""
        ex = self.executor
        if ex is not None and ex.in_pool_thread():
            return
        inf.wait_for_cache_sync()

    # -- overridables ------------------------------------------------------

    def reconcile(self, key: Hashable) -> None:
        raise NotImplementedError

    def reconcile_batch(self, keys: List[Hashable]) -> None:
        """Process a same-tenant batch (fair-queue coalescing); default is
        item-at-a-time with independent retry accounting."""
        for key in keys:
            self._reconcile_one(key)

    def scan(self) -> int:
        """Periodic remediation pass; returns the number of items touched."""
        return 0

    def on_start(self) -> None:
        """Hook run after informer cache sync, before workers start."""

    def on_stop(self) -> None:
        """Hook run during stop, before worker threads are joined."""

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        with self._lifecycle_lock:
            if self._running:
                return
            self._running = True
            self._stop = threading.Event()   # fresh event: restart works
            self._scan_failing = False
            informers = list(self._informers)
            ex = self.executor
        if ex is not None:
            ex.start()   # idempotent: first controller up brings the pool up
        for inf in informers:
            inf.start(executor=ex)
        for inf in informers:
            inf.wait_for_cache_sync()
        self.on_start()
        # aggregate informer accounting (cache memory budget, evict/resync,
        # relist-vs-resume) — one gauge set per controller, not per informer,
        # so a 1k-tenant fleet doesn't register 25k gauges
        def _inf_sum(attr_of: Callable[[Informer], float]) -> Callable[[], float]:
            return lambda: sum(attr_of(i) for i in tuple(self._informers))
        self.metrics.register_gauge(
            "informer_cache_nbytes",
            _inf_sum(lambda i: i.cache.nbytes_estimate()), controller=self.name)
        self.metrics.register_gauge(
            "informer_cache_evictions",
            _inf_sum(lambda i: i.cache.evict_count), controller=self.name)
        self.metrics.register_gauge(
            "informer_cache_resyncs",
            _inf_sum(lambda i: i.cache.resync_count), controller=self.name)
        self.metrics.register_gauge(
            "informer_relists",
            _inf_sum(lambda i: i.relist_count), controller=self.name)
        self.metrics.register_gauge(
            "informer_resumes",
            _inf_sum(lambda i: i.resume_count), controller=self.name)
        if self.queue is not None:
            reopen = getattr(self.queue, "reopen", None)
            if reopen is not None:
                reopen()
            self.metrics.register_gauge(
                "queue_depth", lambda: len(self.queue), controller=self.name)
            if ex is not None:
                use_executor = getattr(self.queue, "use_executor", None)
                if use_executor is not None:
                    use_executor(ex)     # delayed retries -> shared timer wheel
                for i in range(self.workers):
                    # defer + subscribe-then-wake: no add is ever missed
                    t = ex.spawn(self._worker_quantum,
                                 name=f"{self.name}-worker-{i}", defer=True)
                    self._tasks.append(t)
                    self.queue.subscribe(t.wake)
                    t.wake()
            else:
                for i in range(self.workers):
                    t = threading.Thread(target=self._worker,
                                         name=f"{self.name}-worker-{i}",
                                         daemon=True)
                    t.start()
                    self._threads.append(t)
        if self.scan_interval > 0:
            if ex is not None:
                self._tasks.append(
                    ex.spawn(self._scan_quantum, name=f"{self.name}-scan",
                             delay=self.scan_interval))
            else:
                t = threading.Thread(target=self._scan_loop,
                                     name=f"{self.name}-scan", daemon=True)
                t.start()
                self._threads.append(t)

    def stop(self) -> None:
        with self._lifecycle_lock:
            if not self._running:
                return
            self._running = False
            informers = list(self._informers)
            self._stop.set()   # under the lock: a racing start() swaps the
            #                    event first or sees _running and bails
            tasks = list(self._tasks)
        if self.queue is not None:
            self.queue.shutdown()
            for t in tasks:
                self.queue.unsubscribe(t.wake)
        for inf in informers:
            inf.stop()
        self.on_stop()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads.clear()
        for t in tasks:
            t.cancel()       # idle/ready die now; a running quantum finishes
        for t in tasks:
            t.join(timeout=5.0)
        with self._lifecycle_lock:
            self._tasks.clear()

    @property
    def running(self) -> bool:
        with self._lifecycle_lock:
            return self._running

    def healthy(self) -> bool:
        """Running, no worker/scan thread or cooperative task has died, and
        the last periodic scan (if any) succeeded."""
        with self._lifecycle_lock:
            if not self._running:
                return False
            if self._scan_failing:
                return False
            if self._tasks:
                ex = self.executor
                if ex is None or not ex.running:
                    return False
                return all(t.alive for t in self._tasks)
            return all(t.is_alive() for t in self._threads)

    # -- worker machinery --------------------------------------------------

    def _worker(self) -> None:
        q = self.queue
        fair = isinstance(q, FairWorkQueue)
        while not self._stop.is_set():
            if fair and self.batch_size > 1:
                items = q.get_batch(self.batch_size, timeout=0.2)
                if not items:
                    continue
                self.metrics.observe("batch_size", len(items),
                                     controller=self.name)
                self.reconcile_batch(items)
            else:
                item = q.get(timeout=0.2)
                if item is None:
                    continue
                self._reconcile_one(item)

    # items per cooperative quantum (amortizes dispatch without hogging the
    # pool; batched fair-queue dispatch already coalesces, so one per quantum)
    _QUANTUM_ITEMS = 8

    def _worker_quantum(self) -> Any:
        """One cooperative worker quantum: drain a bounded number of items,
        then yield (AGAIN) or park on the queue's waker (WAIT)."""
        if self._stop.is_set():
            return Task.DONE
        q = self.queue
        if isinstance(q, FairWorkQueue) and self.batch_size > 1:
            items = q.get_batch(self.batch_size, timeout=0)
            if not items:
                return Task.WAIT
            self.metrics.observe("batch_size", len(items),
                                 controller=self.name)
            self.reconcile_batch(items)
            return Task.AGAIN
        for _ in range(self._QUANTUM_ITEMS):
            item = q.get(timeout=0)
            if item is None:
                return Task.WAIT
            self._reconcile_one(item)
            if self._stop.is_set():
                return Task.DONE
        return Task.AGAIN

    def _reconcile_one(self, item: Hashable) -> None:
        t0 = time.monotonic()
        m = self.metrics
        try:
            self.reconcile(item)
            self.limiter.forget(item)
            m.inc("reconcile_total", controller=self.name)
        except BaseException as e:
            if isinstance(e, self.drop_on):
                self.limiter.forget(item)
                m.inc("reconcile_dropped", controller=self.name)
            elif isinstance(e, self.retry_on):
                self._requeue(item)
            else:
                m.inc("reconcile_errors", controller=self.name)
        finally:
            m.observe("reconcile_seconds", time.monotonic() - t0,
                      controller=self.name)
            self.queue.done(item)

    def _retry_queue(self, item: Hashable) -> AnyQueue:
        """Queue a retried item re-enters — overridable so sharded
        controllers can route it to the item's CURRENT owner (a tenant may
        have migrated shards while the item was in flight)."""
        return self.queue

    def _requeue(self, item: Hashable) -> None:
        delay = self.limiter.when(item)
        if self.max_retries is not None and \
                self.limiter.retries(item) > self.max_retries:
            self.limiter.forget(item)
            self.metrics.inc("reconcile_exhausted", controller=self.name)
            return
        self.metrics.inc("reconcile_retries", controller=self.name)
        q = self._retry_queue(item)
        ex = self.executor
        if isinstance(q, FairWorkQueue):
            if ex is not None and delay > 0:
                # honour the backoff on the shared timer wheel: an immediate
                # re-add would hot-spin RetryLater conditions (add -> wake ->
                # raise) and starve the task that clears them. The owning
                # queue is re-resolved AT FIRE TIME — a migration during the
                # backoff would otherwise strand the key on a drained queue.
                ex.call_later(delay, lambda: self._readd_fair(item),
                              name=f"{self.name}-retry")
            else:
                q.add(*item)            # re-enters the tenant sub-queue
        elif isinstance(q, DelayingQueue):
            q.add_after(item, delay)
        elif ex is not None and delay > 0:
            # plain queue on the executor: same timer-wheel backoff
            ex.call_later(delay, lambda: q.add(item),
                          name=f"{self.name}-retry")
        else:
            q.add(item)

    def _readd_fair(self, item: Hashable) -> None:
        """Re-add a retried fair-queue item to its CURRENT owning queue,
        re-checking after the add (mirrors the tenant event handlers): if a
        migration raced us, the destination dedups the double add."""
        while True:
            q = self._retry_queue(item)
            q.add(*item)
            if self._retry_queue(item) is q:
                return

    # -- periodic scan -----------------------------------------------------

    def _scan_loop(self) -> None:
        while not self._stop.wait(self.scan_interval):
            self.scan_once()

    def _scan_quantum(self) -> Any:
        """Cooperative periodic scan: one pass, then re-arm the timer wheel.
        A failing scan keeps retrying (unlike the thread fallback, whose
        scan thread dies) but flags the controller unhealthy until a pass
        succeeds, so both modes surface a broken scan in ``healthy()``."""
        if self._stop.is_set():
            return Task.DONE
        try:
            self.scan_once()
            with self._lifecycle_lock:   # _scan_failing is lock-guarded
                self._scan_failing = False
        except Exception:
            with self._lifecycle_lock:
                self._scan_failing = True
            self.metrics.inc("scan_errors", controller=self.name)
        return self.scan_interval

    def scan_once(self) -> int:
        t0 = time.monotonic()
        n = self.scan()
        dur = time.monotonic() - t0
        m = self.metrics
        m.inc("scan_runs", controller=self.name)
        m.inc("scan_items", float(n), controller=self.name)
        m.observe("scan_seconds", dur, controller=self.name)
        return n


# --------------------------------------------------------------------- manager

class ControllerManager:
    """Owns controller lifecycle, the shared metrics registry, and (when
    given one) the shared cooperative executor.

    Controllers start in registration order and stop in reverse, so wiring
    the cluster is just ``add()`` calls in dependency order. Adding to a
    started manager starts the controller immediately. An ``executor`` is
    adopted by every added controller that doesn't already have one, started
    before the first controller, shut down after the last, and exported as
    gauges (pool size, ready-task backlog, timer-wheel depth) on the shared
    registry.
    """

    def __init__(self, metrics: Optional[MetricsRegistry] = None,
                 executor: Optional[CooperativeExecutor] = None):
        self.metrics = metrics or MetricsRegistry()
        self.executor = executor
        if executor is not None:
            self._register_executor_gauges()
        self._controllers: List[Controller] = []
        self._lock = threading.Lock()
        self._started = False

    def _register_executor_gauges(self) -> None:
        ex = self.executor
        m = self.metrics
        m.register_gauge("executor_pool_size", lambda: ex.pool_size)
        m.register_gauge("executor_threads", ex.thread_count)
        m.register_gauge("executor_ready_backlog", ex.ready_backlog)
        m.register_gauge("executor_timer_depth", ex.timer_depth)
        m.register_gauge("executor_tasks", ex.task_count)
        m.register_gauge("executor_quanta_total", lambda: ex.quanta_total)
        m.register_gauge("executor_quanta_seconds_total",
                         lambda: ex.quanta_seconds)
        m.register_gauge("executor_task_errors", lambda: ex.task_errors)
        m.register_gauge("executor_resizes_total", lambda: ex.resizes)

    def add(self, *controllers: Controller) -> None:
        with self._lock:
            started = self._started
            for c in controllers:
                c.metrics = self.metrics
                if c.executor is None:
                    c.executor = self.executor
                self._controllers.append(c)
        if started:
            for c in controllers:
                c.start()

    def remove(self, *controllers: Controller) -> None:
        """Drop controllers from managed lifecycle/health (the caller stops
        them — e.g. ``Syncer.resize_shards`` retiring a drained shard)."""
        with self._lock:
            for c in controllers:
                if c in self._controllers:
                    self._controllers.remove(c)

    def controller(self, name: str) -> Optional[Controller]:
        with self._lock:
            for c in self._controllers:
                if c.name == name:
                    return c
        return None

    def start(self) -> None:
        with self._lock:
            self._started = True
            controllers = list(self._controllers)
        if self.executor is not None:
            self.executor.start()
        for c in controllers:
            c.start()

    def stop(self) -> None:
        with self._lock:
            self._started = False
            controllers = list(self._controllers)
        for c in reversed(controllers):
            c.stop()
        if self.executor is not None:
            self.executor.shutdown()

    def healthy(self) -> Dict[str, bool]:
        with self._lock:
            controllers = list(self._controllers)
        return {c.name: c.healthy() for c in controllers}

    def __enter__(self) -> "ControllerManager":
        self.start()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.stop()
