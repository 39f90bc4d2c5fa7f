"""client-go informer machinery: Reflector -> thread-safe cache -> handlers.

Mirrors the paper's Fig.3: a reflector watches one resource type on one
apiserver; deltas update a read-only cache and fire event handlers, which
typically enqueue keys into a work queue. Reconcilers read the cache, never
the apiserver (paper §III-C: "state comparisons are made against ... informer
caches to avoid intensive direct apiserver queries").

v2 reflector protocol (the store's scale-wall semantics, threaded through):

- **Paged, zero-copy initial LIST.** The cold sync drains
  ``list_paged(..., copy=False)`` page by page — shared READ-ONLY refs, so
  syncing a 100k-object kind deepcopies NOTHING and never holds the store
  lock across the whole keyspace. The cache stores those refs (client-go
  discipline: informer-cache objects are read-only; every consumer that
  mutates must copy first — which all of ours do via update/update_status).
- **Resume, don't relist.** On watch-channel overflow the reflector retries
  ``watch(from_rv=last_seen_rv)``: the store replays the missed events from
  its backlog ring. Only when the ring has evicted that rv
  (:class:`~repro_torch.core.store.ResourceVersionExpired`) does it fall back to
  a full relist. BOOKMARK events advance ``last_seen_rv`` while the kind is
  idle so a quiet informer stays resumable.
- **Bounded cache memory.** An optional byte budget evicts least-recently
  written entries (accounted O(1)); evicted keys are remembered and read
  through the apiserver on access, so correctness degrades to extra GETs,
  never to wrong "not found" answers. Eviction/resync counters are exported
  via ``MetricsRegistry`` when the owning controller wires metrics.

Two reflector modes share one cache/handler surface:

- **thread mode** (default): one OS thread blocks in ``watch.next()`` — the
  legacy/fallback path;
- **cooperative mode** (``start(executor=...)``): the reflector is a state
  machine task on a shared :class:`~repro_torch.core.executor.CooperativeExecutor`.
  It drains a bounded batch of events per quantum via ``_Watch.poll()`` and
  parks (zero threads) on the watch's waker when idle, so thousands of
  informers cost O(pool size) threads instead of one thread each.
"""
from __future__ import annotations

import sys
import threading
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

from .apiserver import APIServer
from .executor import CooperativeExecutor, Task
from .store import ADDED, BOOKMARK, DELETED, ResourceVersionExpired

Handler = Callable[[str, Any], None]   # (event_type, object)

# events drained per cooperative quantum before yielding the pool
PUMP_QUANTUM = 256
RELIST_BACKOFF = 0.05
# page size for the reflector's initial LIST
LIST_PAGE_LIMIT = 1024


def _obj_nbytes(obj: Any) -> int:
    """Rough per-object footprint for the cache budget / Fig.10 accounting."""
    return sys.getsizeof(obj) + 512


class InformerCache:
    """Thread-safe read-only object cache keyed by (namespace, name).

    With ``budget_bytes`` set, the cache evicts least-recently WRITTEN
    entries once the (O(1)-tracked) byte estimate exceeds the budget.
    Evicted keys stay known: :meth:`get` reads them back through ``loader``
    (the apiserver) and re-admits them, so a budgeted cache returns None
    only for keys that truly don't exist — reconcilers that treat a cache
    miss as "deleted" stay correct, at the price of extra GETs
    (``resync_count``)."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 loader: Optional[Callable[[str, str], Optional[Any]]] = None):
        self._lock = threading.Lock()
        self._items: Dict[Tuple[str, str], Any] = {}
        self._nbytes = 0
        self._sizes: Dict[Tuple[str, str], int] = {}
        self.budget_bytes = budget_bytes
        self._loader = loader
        self._evicted: Set[Tuple[str, str]] = set()
        self.evict_count = 0
        self.resync_count = 0

    def set_loader(self, loader: Optional[Callable[[str, str], Optional[Any]]]
                   ) -> None:
        self._loader = loader

    def get(self, namespace: str, name: str) -> Optional[Any]:
        key = (namespace, name)
        with self._lock:
            obj = self._items.get(key)
            if obj is not None:
                return obj
            if key not in self._evicted:
                return None
            loader = self._loader
        if loader is None:
            return None
        # read-through resync, OUTSIDE the lock (it hits the apiserver)
        obj = loader(namespace, name)
        with self._lock:
            if key not in self._evicted:
                # raced with a concurrent event: the reflector's answer wins
                return self._items.get(key)
            if obj is None:
                self._evicted.discard(key)   # truly gone
                return None
            self._evicted.discard(key)
            self._insert_locked(key, obj)
            self.resync_count += 1
            self._enforce_budget_locked(keep=key)
            return obj

    def peek(self, namespace: str, name: str) -> Optional[Any]:
        """Resident-only lookup: never reads through the apiserver (used by
        the replay ghost-sweep, where a miss means "evicted or gone")."""
        with self._lock:
            return self._items.get((namespace, name))

    def list(self, namespace: Optional[str] = None) -> List[Any]:
        """Resident entries (evicted keys are NOT read back — use
        :meth:`get` for guaranteed-correct single-key reads, or keep the
        cache unbudgeted for consumers that list)."""
        with self._lock:
            return [o for (ns, _), o in self._items.items()
                    if namespace is None or ns == namespace]

    def keys(self) -> List[Tuple[str, str]]:
        with self._lock:
            if self._evicted:
                return list(self._items.keys()) + list(self._evicted)
            return list(self._items.keys())

    def __len__(self) -> int:
        with self._lock:
            return len(self._items) + len(self._evicted)

    def _insert_locked(self, key: Tuple[str, str], obj: Any) -> None:
        old = self._sizes.pop(key, 0)
        # pop+reinsert keeps dict order = write recency (the eviction order)
        self._items.pop(key, None)
        self._items[key] = obj
        size = _obj_nbytes(obj)
        self._sizes[key] = size
        self._nbytes += size - old

    def _remove_locked(self, key: Tuple[str, str]) -> None:
        self._items.pop(key, None)
        self._nbytes -= self._sizes.pop(key, 0)
        self._evicted.discard(key)

    def _enforce_budget_locked(self, keep: Optional[Tuple[str, str]] = None
                               ) -> None:
        if self.budget_bytes is None:
            return
        while self._nbytes > self.budget_bytes and len(self._items) > 1:
            victim = next(iter(self._items))   # least-recently written
            if victim == keep:
                break
            self._items.pop(victim)
            self._nbytes -= self._sizes.pop(victim, 0)
            self._evicted.add(victim)
            self.evict_count += 1

    def _apply(self, ev_type: str, obj: Any) -> None:
        key = (obj.metadata.namespace, obj.metadata.name)
        with self._lock:
            if ev_type == DELETED:
                self._remove_locked(key)
            else:
                self._evicted.discard(key)
                self._insert_locked(key, obj)
                self._enforce_budget_locked(keep=key)

    def _drop(self, namespace: str, name: str) -> None:
        """Forget a key without an object (ghost-sweep of an evicted entry
        that vanished between relists)."""
        with self._lock:
            self._remove_locked((namespace, name))

    def nbytes_estimate(self) -> int:
        """O(1) memory estimate for the Fig.10 overhead accounting."""
        with self._lock:
            return self._nbytes


class Informer:
    """Reflector (thread or cooperative task) + cache + handler fan-out for
    one (apiserver, kind)."""

    def __init__(self, api: APIServer, kind: str,
                 namespace: Optional[str] = None, name: str = "",
                 cache_budget_bytes: Optional[int] = None,
                 page_limit: int = LIST_PAGE_LIMIT,
                 watch_buffer: int = 100_000):
        self.api = api
        self.kind = kind
        self.namespace = namespace
        self.name = name or f"{api.name}/{kind}"
        self.cache = InformerCache(
            budget_bytes=cache_budget_bytes, loader=self._load_one)
        self.page_limit = page_limit
        self.watch_buffer = watch_buffer
        self._handlers: List[Handler] = []
        self._stop = threading.Event()
        self._synced = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._task: Optional[Task] = None
        self._executor: Optional[CooperativeExecutor] = None
        self._watch: Optional[Any] = None
        self._pstate = "relist"
        # highest resourceVersion seen (events + bookmarks): the resume point
        self.last_seen_rv = 0
        self.relist_count = 0
        self.resume_count = 0
        self.bookmark_count = 0
        self.connect_errors = 0    # failed reflector (re)connect attempts
        self.handler_errors = 0    # event handlers that raised

    def _load_one(self, namespace: str, name: str) -> Optional[Any]:
        """Cache read-through for evicted keys (None = truly not found)."""
        from .store import NotFoundError
        try:
            return self.api.get(self.kind, namespace, name)
        except NotFoundError:
            return None

    def add_handler(self, handler: Handler) -> None:
        self._handlers.append(handler)

    def export_metrics(self, metrics: Any, **labels: Any) -> None:
        """Register this informer's cache/reflector accounting as gauges on
        a :class:`~repro_torch.core.runtime.MetricsRegistry`."""
        labels.setdefault("informer", self.name)
        metrics.register_gauge("informer_cache_nbytes",
                               self.cache.nbytes_estimate, **labels)
        metrics.register_gauge("informer_cache_evictions",
                               lambda: self.cache.evict_count, **labels)
        metrics.register_gauge("informer_cache_resyncs",
                               lambda: self.cache.resync_count, **labels)
        metrics.register_gauge("informer_relists",
                               lambda: self.relist_count, **labels)
        metrics.register_gauge("informer_resumes",
                               lambda: self.resume_count, **labels)
        metrics.register_gauge("informer_connect_errors",
                               lambda: self.connect_errors, **labels)
        metrics.register_gauge("informer_handler_errors",
                               lambda: self.handler_errors, **labels)

    @property
    def alive(self) -> bool:
        if self._thread is not None and self._thread.is_alive():
            return True
        return self._task is not None and self._task.alive

    def start(self, executor: Optional[CooperativeExecutor] = None) -> None:
        """Start the reflector: cooperative pump task when ``executor`` is
        given, dedicated thread otherwise. Idempotent while alive (an
        adopted informer keeps its running reflector, whatever its mode)."""
        if self.alive:
            return
        # fresh events so a stopped informer can be restarted (cache rebuild)
        self._stop = threading.Event()
        self._synced.clear()
        if executor is not None:
            self._thread = None
            self._watch = None
            self._pstate = "relist"
            self._executor = executor
            # defer + publish-then-wake: the first quantum reads self._task
            task = executor.spawn(self._pump, name=f"informer:{self.name}",
                                  defer=True)
            self._task = task
            task.wake()
            return
        self._task = None
        self._executor = None
        self._thread = threading.Thread(
            target=self._run, name=f"informer:{self.name}", daemon=True)
        self._thread.start()

    def wait_for_cache_sync(self, timeout: float = 30.0) -> bool:
        # vclint: disable=VCL002 startup-only barrier, as baselined for repro.core
        return self._synced.wait(timeout)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if self._task is not None:
            watch = self._watch
            if watch is not None:
                watch.close()       # fires the waker: prompt wakeup
            self._task.wake()       # covers the pre-watch (relist) state
            # Joining from a pool thread (e.g. the tenant operator tearing a
            # tenant down) would park the thread the pump task needs for its
            # final quantum — self-deadlock at small pools. The task still
            # terminates asynchronously via the stop event.
            ex = self._executor
            if ex is None or not ex.in_pool_thread():
                self._task.join(timeout=5.0)

    # -- shared replay/connect ----------------------------------------------

    def _replay(self, snapshot: List[Any]) -> None:
        """Replay a list snapshot as ADDED events (client-go initial sync),
        dropping cache entries that vanished between relists."""
        seen = set()
        for obj in snapshot:
            seen.add((obj.metadata.namespace, obj.metadata.name))
            self._dispatch(ADDED, obj)
        for key in self.cache.keys():
            if key not in seen:
                # peek, not get: a read-through here would GET every evicted
                # key against the apiserver on every relist
                ghost = self.cache.peek(*key)
                if ghost is not None:
                    self._dispatch(DELETED, ghost)
                else:
                    self.cache._drop(*key)   # evicted + gone: forget the key
        self._synced.set()

    def _connect(self) -> Optional[Any]:
        """One reflector (re)connect attempt: resume from ``last_seen_rv``
        when the store's backlog still covers it, else paged relist + watch
        from the snapshot's rv. Returns the open watch, or None to retry
        after backoff. Events use ``copy=False`` throughout: the cache and
        handlers receive shared READ-ONLY refs, so a cold 100k-object sync
        performs zero deepcopies."""
        if self.last_seen_rv:
            try:
                w = self.api.watch(self.kind, self.namespace,
                                   from_rv=self.last_seen_rv, copy=False,
                                   buffer=self.watch_buffer)
                self.resume_count += 1
                self._synced.set()
                return w
            except ResourceVersionExpired:
                pass                 # backlog evicted our rv: full relist
            except Exception:
                self.connect_errors += 1   # visible via export_metrics
                return None          # retried after RELIST_BACKOFF
        try:
            snapshot, rv = self.api.list_all_pages(
                self.kind, self.namespace, limit=self.page_limit, copy=False)
            w = self.api.watch(self.kind, self.namespace,
                               from_rv=rv, copy=False,
                               buffer=self.watch_buffer)
        except ResourceVersionExpired:
            return None   # churn outran the backlog between list and watch
        except Exception:
            self.connect_errors += 1       # visible via export_metrics
            return None
        self.relist_count += 1
        self._replay(snapshot)
        self.last_seen_rv = max(self.last_seen_rv, rv)
        return w

    # -- reflector loop (thread mode) ----------------------------------------

    def _run(self) -> None:
        while not self._stop.is_set():
            watch = self._connect()
            if watch is None:
                self._stop.wait(RELIST_BACKOFF)
                continue
            while not self._stop.is_set():
                ev = watch.next(timeout=0.2)
                if ev is None:
                    if watch.closed:
                        break  # channel overflowed/closed: resume or relist
                    continue
                self.last_seen_rv = max(self.last_seen_rv,
                                        ev.resource_version)
                if ev.type == BOOKMARK:
                    self.bookmark_count += 1
                    continue
                self._dispatch(ev.type, ev.object)
            watch.close()

    # -- reflector pump (cooperative mode) -----------------------------------

    def _pump(self) -> Any:
        """One quantum of the cooperative reflector state machine."""
        if self._stop.is_set():
            watch, self._watch = self._watch, None
            if watch is not None:
                watch.close()
            return Task.DONE
        if self._pstate == "relist":
            watch = self._connect()
            if watch is None:
                return RELIST_BACKOFF
            self._watch = watch
            self._pstate = "pump"
            # events pushed during replay are buffered; set_waker fires
            # immediately if any are pending, so none are stranded
            watch.set_waker(self._task.wake)
            return Task.AGAIN
        watch = self._watch
        for _ in range(PUMP_QUANTUM):
            ev = watch.poll()
            if ev is None:
                if watch.closed:   # overflowed/closed: resume or relist
                    watch.close()
                    self._watch = None
                    self._pstate = "relist"
                    return Task.AGAIN
                return Task.WAIT   # waker fires on the next push
            self.last_seen_rv = max(self.last_seen_rv, ev.resource_version)
            if ev.type == BOOKMARK:
                self.bookmark_count += 1
                continue
            self._dispatch(ev.type, ev.object)
        return Task.AGAIN          # quantum spent; yield the pool

    def _dispatch(self, ev_type: str, obj: Any) -> None:
        self.cache._apply(ev_type, obj)
        for h in self._handlers:
            try:
                h(ev_type, obj)
            except Exception:
                # a broken handler must not kill the reflector, but the
                # failure has to be visible (export_metrics gauge)
                self.handler_errors += 1
