"""Versioned, watchable object store — the etcd analogue (v2).

Semantics modelled on etcd + the k8s apiserver storage layer:
- a single monotonically increasing resourceVersion counter per store;
- optimistic concurrency: update() with a stale resourceVersion conflicts;
- watches deliver ADDED/MODIFIED/DELETED events in version order;
- reads return copies (mutating a returned object never mutates the store).

v2 rebuilds the READ path for the O(1k)-tenant / O(100k)-object regime:

- **Per-kind indexes.** Objects are indexed by kind and by (kind,
  namespace), so ``list``/``count`` touch only the requested kind instead
  of scanning every object in the store. ``count`` is O(1) (a dict ``len``).
- **Copy-on-write snapshot LIST.** Stored objects are never mutated in
  place — every write installs a fresh copy — so a LIST only needs the
  write lock long enough to grab an immutable per-(kind, ns) snapshot
  tuple (pointer copies, cached until the next write to that kind).
  The public API still returns deepcopies, but they are made OUTSIDE the
  lock; trusted in-process consumers (reflectors, the anti-entropy scan)
  pass ``copy=False`` and get the shared refs with a read-only contract —
  exactly client-go's informer-cache discipline.
- **Paged LIST.** ``list_page(kind, ns, limit=, continue_token=)`` returns
  ``(page, continue_token, rv)`` k8s-style. The continue token pins the
  snapshot the first page was served from, so pagination is perfectly
  consistent at one resourceVersion and costs no server-side retention
  bookkeeping — dropping the token releases the snapshot.
- **Resumable watches.** Every event is appended to a bounded per-kind
  backlog ring; ``watch(kind, from_rv=...)`` replays the ring from a known
  resourceVersion instead of forcing a cold relist, raising
  :class:`ResourceVersionExpired` (the 410 Gone analogue) only when the
  ring has evicted events past ``from_rv``. Periodic BOOKMARK events
  (amortized: every ``bookmark_every`` writes) advance idle watchers'
  resume points so a quiet informer's rv does not fall out of the ring.
- **Indexed watch fan-out.** Watch registration is keyed by
  ``(kind, namespace)``; a write notifies only the matching watchers
  instead of linearly scanning every watch in the store, and dead watches
  unregister themselves from the index on close/overflow.
- **Zero-copy events (opt-in).** Stored objects are immutable-in-place,
  so a ``watch(..., copy=False)`` stream carries the stored object itself
  — a write costs ZERO deepcopies no matter how many such watchers exist.
  Default watches keep the v1 contract (events carry copies, one lazy
  shared copy per write); the backlog ring always holds raw refs, so an
  unwatched write never copies at all.
"""
from __future__ import annotations

import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import (Any, Callable, Deque, Dict, List, Optional, Tuple)

from . import sanitize
from . import trace as trace_mod
from .objects import deepcopy_obj, new_uid, obj_key

ADDED, MODIFIED, DELETED = "ADDED", "MODIFIED", "DELETED"
# rv checkpoint for idle watchers; carries no object (k8s bookmark analogue)
BOOKMARK = "BOOKMARK"

Key = Tuple[str, str, str]             # (kind, namespace, name)


class ConflictError(Exception):
    """Optimistic-concurrency failure (stale resourceVersion)."""


class AlreadyExistsError(Exception):
    pass


class NotFoundError(Exception):
    pass


class ResourceVersionExpired(Exception):
    """The backlog ring no longer covers ``from_rv`` (410 Gone analogue):
    the client must fall back to a full relist."""


@dataclass
class WatchEvent:
    type: str              # ADDED | MODIFIED | DELETED | BOOKMARK
    object: Any            # None for BOOKMARK; READ-ONLY shared ref otherwise
    resource_version: int


@dataclass
class ContinueToken:
    """Opaque pagination cursor: pins the snapshot the first page was served
    from, so every page of one LIST is consistent at ``rv``. Dropping the
    token releases the snapshot — no server-side retention to expire."""
    rv: int
    _snap: Tuple[Any, ...] = field(repr=False)
    _pos: int = 0


class _Watch:
    """A single watch stream: bounded event buffer + close signal.

    Two consumption modes: the blocking :meth:`next` (reflector threads) and
    the non-blocking :meth:`poll` + :meth:`set_waker` pair (cooperative
    informer pumps — the waker fires on every push and on close, so an idle
    pump parks no thread). Event objects are shared with the store and every
    other watcher: READ-ONLY by contract."""

    def __init__(self, kind: str, namespace: Optional[str],
                 maxlen: int = 100_000,
                 unregister: Optional[Callable[["_Watch"], None]] = None,
                 copy_events: bool = True, sanitize_events: bool = False):
        self.kind = kind
        self.namespace = namespace
        # True: events carry deepcopies (safe to mutate). False: events
        # share the stored object — READ-ONLY contract, zero copy cost.
        self.copy_events = copy_events
        # REPRO_SANITIZE=1 + copy_events=False: hand shared refs out as
        # deep-frozen proxies (set by the owning store at registration)
        self.sanitize_events = sanitize_events and not copy_events
        self._events: Deque[WatchEvent] = deque()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._closed = False
        self._overflowed = False
        self._maxlen = maxlen
        self._waker: Optional[Callable[[], None]] = None
        self._unregister = unregister
        # rv of the newest event pushed (bookmarks included); read by the
        # store's bookmark sweep to skip watchers that are already current
        self.last_pushed_rv = 0

    def _push(self, ev: WatchEvent) -> bool:
        """Append one event; returns False once the stream is closed or just
        overflowed (the store drops dead watches from its index on False)."""
        with self._cv:
            if self._closed:
                return False
            if len(self._events) >= self._maxlen:
                # etcd watch-channel overflow: the client must resume from
                # its last seen rv (backlog ring) or relist.
                self._overflowed = True
                self._closed = True
            else:
                self._events.append(ev)
                self.last_pushed_rv = max(self.last_pushed_rv,
                                          ev.resource_version)
            self._cv.notify_all()
            waker = self._waker
            accepted = not self._closed
        if waker is not None:
            waker()
        return accepted

    def next(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            # loop: Condition.wait can return spuriously, and a bare single
            # wait would make an open stream look closed/overflowed
            while not self._events and not self._closed:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return None  # timed out
                self._cv.wait(remaining)
            if self._events:
                return self._deliver(self._events.popleft())
            return None  # closed

    def poll(self) -> Optional[WatchEvent]:
        """Non-blocking :meth:`next`: an event if buffered, else None (check
        :attr:`closed` to tell "idle" from "stream over")."""
        with self._cv:
            if self._events:
                return self._deliver(self._events.popleft())
            return None

    def _deliver(self, ev: WatchEvent) -> WatchEvent:
        """Sanitize hook at the consumer boundary: zero-copy events leave as
        deep-frozen proxies, so the blamed site is the consumer's poll."""
        if self.sanitize_events and ev.object is not None:
            return WatchEvent(ev.type, sanitize.freeze(ev.object),
                              ev.resource_version)
        return ev

    def set_waker(self, waker: Optional[Callable[[], None]]) -> None:
        """Install an on-ready callback, fired on every push and on close.
        Fires immediately if events are already buffered (or the stream is
        closed), so no readiness edge is lost between poll() and arming."""
        with self._cv:
            self._waker = waker
            fire = waker is not None and (bool(self._events) or self._closed)
        if fire:
            waker()

    def close(self) -> None:
        with self._cv:
            already = self._closed
            self._closed = True
            self._cv.notify_all()
            waker = self._waker
        # outside the watch lock: unregister takes the store lock, and the
        # store's notify path holds its lock while taking ours — same-order
        # acquisition here would deadlock
        if not already and self._unregister is not None:
            self._unregister(self)
        if waker is not None:
            waker()

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed and not self._events

    @property
    def overflowed(self) -> bool:
        with self._cv:
            return self._overflowed


class ObjectStore:
    """Thread-safe versioned store for API objects.

    ``backlog`` bounds the per-kind resumable-watch event ring;
    ``bookmark_every`` is the write-count interval of the amortized
    BOOKMARK sweep that keeps idle watchers' resume points fresh."""

    def __init__(self, name: str = "store", *, backlog: int = 8192,
                 bookmark_every: int = 256):
        self.name = name
        # REPRO_SANITIZE=1 (captured at construction): copy=False reads
        # leave as deep-frozen proxies and the store lock gets a hold-time
        # watchdog. Off: zero-cost, behavior byte-identical.
        self._sanitize = sanitize.enabled()
        self._lock: Any = threading.RLock()
        if self._sanitize:
            self._lock = sanitize.WatchdogLock(self._lock,
                                               f"ObjectStore({name})._lock")
        self._objects: Dict[Key, Any] = {}
        self._rv = 0
        # per-kind and per-(kind, namespace) indexes: list/count/page touch
        # only the requested slice of the keyspace
        self._by_kind: Dict[str, Dict[Key, Any]] = {}
        self._by_kind_ns: Dict[Tuple[str, str], Dict[Key, Any]] = {}
        # immutable snapshot tuples, cached per (kind, ns-or-None) until the
        # next write to that kind invalidates them
        self._snapshots: Dict[Tuple[str, Optional[str]],
                              Tuple[int, Tuple[Any, ...]]] = {}
        # watch index: (kind, ns-or-None) -> watchers; writes touch only
        # the two matching buckets instead of every watch in the store
        self._watches: Dict[Tuple[str, Optional[str]], List[_Watch]] = {}
        # resumable-watch backlog: per-kind ring of recent events plus the
        # highest rv ever evicted from it (the resume-coverage boundary)
        self._backlog_maxlen = max(1, int(backlog))
        self._backlog: Dict[str, Deque[WatchEvent]] = {}
        self._evicted_rv: Dict[str, int] = {}
        self._bookmark_every = max(1, int(bookmark_every))
        self._writes_since_bookmark = 0
        self.bookmarks_sent = 0
        # optional Tracer: writes whose object carries a traceparent
        # annotation record an instant "store.commit" child span. One attr
        # check per write when unset — tracing off costs nothing.
        self.tracer: Optional[Any] = None
        # optional UsageMeter + fixed tenant attribution: tenant stores are
        # single-tenant, so every committed write meters object-bytes under
        # meter_tenant. The super store stays unmetered (its traffic is
        # attributed at the sync lanes instead). Same cost model as tracer.
        self.meter: Optional[Any] = None
        self.meter_tenant = ""

    # -- index maintenance (call under lock) --------------------------------

    def _index_put(self, key: Key, obj: Any) -> None:
        kind, ns, _ = key
        self._objects[key] = obj
        self._by_kind.setdefault(kind, {})[key] = obj
        self._by_kind_ns.setdefault((kind, ns), {})[key] = obj

    def _index_pop(self, key: Key) -> Optional[Any]:
        obj = self._objects.pop(key, None)
        if obj is None:
            return None
        kind, ns, _ = key
        bucket = self._by_kind.get(kind)
        if bucket is not None:
            bucket.pop(key, None)
            if not bucket:
                del self._by_kind[kind]
        nsbucket = self._by_kind_ns.get((kind, ns))
        if nsbucket is not None:
            nsbucket.pop(key, None)
            if not nsbucket:
                del self._by_kind_ns[(kind, ns)]
        return obj

    # -- CRUD ---------------------------------------------------------------

    def _meter_commit(self, objs: Any) -> None:
        """Meter committed object-bytes — OUTSIDE the store lock, one meter
        round per write call regardless of batch size (a per-item hook under
        the lock would stretch every writer's critical section)."""
        m = self.meter
        if m is None:
            return
        if isinstance(objs, list):
            if not objs:
                return
            nbytes = sum(sys.getsizeof(o) for o in objs) + 512 * len(objs)
        else:
            nbytes = sys.getsizeof(objs) + 512
        m.add(self.meter_tenant, "object_bytes", float(nbytes))

    def create(self, obj: Any) -> Any:
        with self._lock:
            key = obj_key(obj)
            if key in self._objects:
                raise AlreadyExistsError(f"{key} already exists")
            stored = deepcopy_obj(obj)
            self._rv += 1
            stored.metadata.uid = stored.metadata.uid or new_uid()
            stored.metadata.resource_version = self._rv
            stored.metadata.creation_timestamp = (
                stored.metadata.creation_timestamp or time.time())
            self._index_put(key, stored)
            self._notify_stored(ADDED, stored, self._rv)
            out = deepcopy_obj(stored)
        self._meter_commit(out)
        return out

    def create_many(self, objs: List[Any]) -> Tuple[List[Any], List[Any]]:
        """Batched create under ONE lock round (etcd-txn analogue).

        Returns ``(created, conflicted)`` — objects whose key already existed
        are returned in ``conflicted`` instead of raising, so callers can
        coalesce a burst and fall back per-item only for the losers.
        """
        created: List[Any] = []
        conflicted: List[Any] = []
        with self._lock:
            for obj in objs:
                key = obj_key(obj)
                if key in self._objects:
                    conflicted.append(obj)
                    continue
                stored = deepcopy_obj(obj)
                self._rv += 1
                stored.metadata.uid = stored.metadata.uid or new_uid()
                stored.metadata.resource_version = self._rv
                stored.metadata.creation_timestamp = (
                    stored.metadata.creation_timestamp or time.time())
                self._index_put(key, stored)
                self._notify_stored(ADDED, stored, self._rv)
                created.append(deepcopy_obj(stored))
        self._meter_commit(created)
        return created, conflicted

    def get(self, kind: str, namespace: str, name: str) -> Any:
        with self._lock:
            obj = self._objects.get((kind, namespace, name))
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
        # stored objects are immutable in place: copy OUTSIDE the lock
        return deepcopy_obj(obj)

    def update(self, obj: Any, *, force: bool = False) -> Any:
        """Replace an object; conflicts on stale resourceVersion unless force."""
        with self._lock:
            key = obj_key(obj)
            cur = self._objects.get(key)
            if cur is None:
                raise NotFoundError(f"{key} not found")
            if not force and obj.metadata.resource_version != cur.metadata.resource_version:
                raise ConflictError(
                    f"{key}: rv {obj.metadata.resource_version} != {cur.metadata.resource_version}")
            stored = deepcopy_obj(obj)
            self._rv += 1
            stored.metadata.uid = cur.metadata.uid
            stored.metadata.creation_timestamp = cur.metadata.creation_timestamp
            stored.metadata.resource_version = self._rv
            self._index_put(key, stored)
            self._notify_stored(MODIFIED, stored, self._rv)
            out = deepcopy_obj(stored)
        self._meter_commit(out)
        return out

    def update_status(self, kind: str, namespace: str, name: str,
                      mutate: Callable[[Any], None]) -> Any:
        """Read-modify-write with retry under the store lock (status subresource)."""
        with self._lock:
            key = (kind, namespace, name)
            cur = self._objects.get(key)
            if cur is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            stored = deepcopy_obj(cur)
            mutate(stored)
            self._rv += 1
            stored.metadata.resource_version = self._rv
            self._index_put(key, stored)
            self._notify_stored(MODIFIED, stored, self._rv)
            out = deepcopy_obj(stored)
        self._meter_commit(out)
        return out

    def delete(self, kind: str, namespace: str, name: str) -> Any:
        with self._lock:
            obj = self._index_pop((kind, namespace, name))
            if obj is None:
                raise NotFoundError(f"{kind} {namespace}/{name} not found")
            self._rv += 1
            self._notify_stored(DELETED, obj, self._rv)
            out = deepcopy_obj(obj)
        self._meter_commit(out)
        return out

    def update_many(self, objs: List[Any], *, force: bool = False
                    ) -> Tuple[List[Any], List[Any]]:
        """Batched update under ONE lock round (etcd-txn analogue).

        Returns ``(updated, conflicted)`` — objects that are missing or carry
        a stale resourceVersion land in ``conflicted`` instead of raising, so
        callers can coalesce a burst and fall back per-item for the losers.
        """
        updated: List[Any] = []
        conflicted: List[Any] = []
        with self._lock:
            for obj in objs:
                key = obj_key(obj)
                cur = self._objects.get(key)
                if cur is None:
                    conflicted.append(obj)
                    continue
                if (not force and obj.metadata.resource_version
                        != cur.metadata.resource_version):
                    conflicted.append(obj)
                    continue
                stored = deepcopy_obj(obj)
                self._rv += 1
                stored.metadata.uid = cur.metadata.uid
                stored.metadata.creation_timestamp = cur.metadata.creation_timestamp
                stored.metadata.resource_version = self._rv
                self._index_put(key, stored)
                self._notify_stored(MODIFIED, stored, self._rv)
                updated.append(deepcopy_obj(stored))
        self._meter_commit(updated)
        return updated, conflicted

    def update_status_many(self, updates: List[Tuple[str, str, str,
                                                     Callable[[Any], None]]]
                           ) -> Tuple[List[Tuple[str, str, str]],
                                      List[Tuple[str, str, str]]]:
        """Batched status read-modify-write under ONE lock round.

        ``updates`` are ``(kind, namespace, name, mutate)`` tuples; each
        ``mutate`` runs against a copy of the stored object, exactly like
        :meth:`update_status`. Returns ``(updated, missing)`` — both KEY
        lists, not object copies: the keys rewritten, and the keys that
        were not found (reported, not raised) so a coalescing caller can
        create-or-retry just the losers. Skipping the per-object return
        copies is deliberate — a status-storm batch would otherwise pay a
        full deepcopy per write for results nobody reads.
        """
        updated: List[Tuple[str, str, str]] = []
        missing: List[Tuple[str, str, str]] = []
        nbytes = 0
        with self._lock:
            for kind, namespace, name, mutate in updates:
                key = (kind, namespace, name)
                cur = self._objects.get(key)
                if cur is None:
                    missing.append(key)
                    continue
                stored = deepcopy_obj(cur)
                mutate(stored)
                self._rv += 1
                stored.metadata.resource_version = self._rv
                self._index_put(key, stored)
                self._notify_stored(MODIFIED, stored, self._rv)
                nbytes += sys.getsizeof(stored)
                updated.append(key)
        m = self.meter
        if m is not None and updated:
            # no object copies survive this call — size accumulated in-loop
            m.add(self.meter_tenant, "object_bytes",
                  float(nbytes + 512 * len(updated)))
        return updated, missing

    def delete_many(self, keys: List[Tuple[str, str, str]]
                    ) -> Tuple[List[Any], List[Tuple[str, str, str]]]:
        """Batched delete under ONE lock round.

        ``keys`` are ``(kind, namespace, name)`` triples. Returns
        ``(deleted, missing)``: copies of the removed objects, and the keys
        that were already gone (reported, not raised).
        """
        deleted: List[Any] = []
        missing: List[Tuple[str, str, str]] = []
        with self._lock:
            for key in keys:
                obj = self._index_pop(key)
                if obj is None:
                    missing.append(key)
                    continue
                self._rv += 1
                self._notify_stored(DELETED, obj, self._rv)
                deleted.append(deepcopy_obj(obj))
        self._meter_commit(deleted)
        return deleted, missing

    # -- snapshot reads -----------------------------------------------------

    def _snapshot_locked(self, kind: str, namespace: Optional[str]
                         ) -> Tuple[int, Tuple[Any, ...]]:
        """Immutable per-(kind, ns) snapshot tuple; cached until the next
        write to the kind. Building it is pointer copies only. Caller holds
        the lock; the returned tuple may be used (and copied) outside it."""
        skey = (kind, namespace)
        hit = self._snapshots.get(skey)
        if hit is not None:
            return hit
        if namespace is None:
            bucket = self._by_kind.get(kind)
        else:
            bucket = self._by_kind_ns.get((kind, namespace))
        snap = (self._rv, tuple(bucket.values()) if bucket else ())
        self._snapshots[skey] = snap
        return snap

    def list(self, kind: str, namespace: Optional[str] = None, *,
             copy: bool = True) -> List[Any]:
        """Snapshot LIST: the lock is held only for the pointer-copy
        snapshot grab; deepcopies (the expensive part) happen OUTSIDE it,
        so a 100k-object LIST no longer stalls writers. ``copy=False``
        returns the shared stored refs — READ-ONLY, for trusted in-process
        consumers (reflectors, scans) that never mutate API objects."""
        with self._lock:
            _, snap = self._snapshot_locked(kind, namespace)
        if not copy:
            if self._sanitize:
                return sanitize.freeze_all(snap)
            return list(snap)
        return [deepcopy_obj(o) for o in snap]

    def list_page(self, kind: str, namespace: Optional[str] = None, *,
                  limit: int = 500,
                  continue_token: Optional[ContinueToken] = None,
                  copy: bool = True
                  ) -> Tuple[List[Any], Optional[ContinueToken], int]:
        """Paged LIST with k8s continue semantics.

        Returns ``(page, continue_token, rv)``; a None token means the list
        is exhausted. All pages of one LIST are served from the snapshot
        pinned by the first page's token, so the result is consistent at
        ``rv`` even under concurrent writes — resume a watch with
        ``watch(kind, ns, from_rv=rv)`` to catch up from there."""
        limit = max(1, int(limit))
        if continue_token is None:
            with self._lock:
                rv, snap = self._snapshot_locked(kind, namespace)
            pos = 0
        else:
            rv, snap, pos = (continue_token.rv, continue_token._snap,
                             continue_token._pos)
        chunk = snap[pos:pos + limit]
        if copy:
            page = [deepcopy_obj(o) for o in chunk]
        elif self._sanitize:
            page = sanitize.freeze_all(chunk)
        else:
            page = list(chunk)
        nxt = pos + limit
        token = (ContinueToken(rv, snap, nxt) if nxt < len(snap) else None)
        return page, token, rv

    def count(self, kind: Optional[str] = None) -> int:
        """O(1): a dict ``len`` on the flat map or the per-kind index."""
        with self._lock:
            if kind is None:
                return len(self._objects)
            bucket = self._by_kind.get(kind)
            return len(bucket) if bucket is not None else 0

    @property
    def resource_version(self) -> int:
        with self._lock:
            return self._rv

    # -- watch --------------------------------------------------------------

    def watch(self, kind: str, namespace: Optional[str] = None, *,
              from_rv: Optional[int] = None,
              buffer: int = 100_000, copy: bool = True) -> _Watch:
        """Open a watch stream for one kind (optionally one namespace).

        ``from_rv`` resumes from a known resourceVersion: events newer than
        it are replayed from the per-kind backlog ring atomically with
        registration, so nothing written between the caller's snapshot and
        the watch's start is lost. Raises :class:`ResourceVersionExpired`
        when the ring has evicted events past ``from_rv`` — the caller must
        relist. ``buffer`` bounds the stream's event buffer (overflow closes
        the stream with ``overflowed`` set, k8s watch-channel semantics).
        ``copy=False`` streams the stored objects themselves (READ-ONLY
        contract) — a write then costs zero deepcopies for this watcher."""
        with self._lock:
            if from_rv is not None and from_rv < self._evicted_rv.get(kind, 0):
                raise ResourceVersionExpired(
                    f"{kind} rv {from_rv} evicted from backlog "
                    f"(oldest resumable: {self._evicted_rv.get(kind, 0)})")
            w = _Watch(kind, namespace, maxlen=buffer,
                       unregister=self._unregister_watch, copy_events=copy,
                       sanitize_events=self._sanitize)
            if from_rv is not None:
                for ev in self._backlog.get(kind, ()):
                    if ev.resource_version <= from_rv:
                        continue
                    if (namespace is not None and ev.object is not None
                            and ev.object.metadata.namespace != namespace):
                        continue
                    w._push(ev if not copy else WatchEvent(
                        ev.type, deepcopy_obj(ev.object), ev.resource_version))
            self._watches.setdefault((kind, namespace), []).append(w)
            return w

    def list_and_watch(self, kind: str, namespace: Optional[str] = None, *,
                       copy: bool = True) -> Tuple[List[Any], _Watch]:
        """Atomic snapshot + watch from that version (reflector primitive).
        The deepcopy of the snapshot (when requested) happens outside the
        lock; only the pointer-copy grab and watch registration are inside.
        ``copy`` applies to both the snapshot and the watch's event stream."""
        with self._lock:
            _, snap = self._snapshot_locked(kind, namespace)
            w = _Watch(kind, namespace, unregister=self._unregister_watch,
                       copy_events=copy, sanitize_events=self._sanitize)
            self._watches.setdefault((kind, namespace), []).append(w)
        if copy:
            out = [deepcopy_obj(o) for o in snap]
        elif self._sanitize:
            out = sanitize.freeze_all(snap)
        else:
            out = list(snap)
        return out, w

    def _unregister_watch(self, w: _Watch) -> None:
        """Drop a closed watch from the index (called from _Watch.close,
        outside the watch's own lock)."""
        with self._lock:
            bucket = self._watches.get((w.kind, w.namespace))
            if bucket is not None:
                try:
                    bucket.remove(w)
                except ValueError:
                    pass
                if not bucket:
                    del self._watches[(w.kind, w.namespace)]

    def _notify_stored(self, ev_type: str, stored: Any, rv: int) -> None:
        """Fan a write out to the matching watch buckets and append it to
        the kind's backlog ring. The ring and ``copy=False`` watchers get an
        event sharing the stored object itself — writes install fresh copies
        and stored objects are never mutated in place, so the shared ref is
        safe. Copying watchers share ONE lazy deepcopy per write (made only
        if such a watcher exists), preserving the mutable-event contract."""
        kind = type(stored).kind
        ns = stored.metadata.namespace
        tr = self.tracer
        if tr is not None:
            tp = stored.metadata.annotations.get(trace_mod.TRACEPARENT_KEY)
            if tp and trace_mod.sampled_carrier(tp):
                # instant span: the commit itself is sub-µs under the lock;
                # what matters for the propagation tree is WHEN it landed.
                # Unsampled carriers skip the record entirely — a zero-
                # duration span can never be tail-retained anyway.
                now = time.monotonic()
                tr.record_from(tp, "store.commit", now, now,
                               attrs={"store": self.name, "kind": kind,
                                      "event": ev_type, "rv": rv})
        ev = WatchEvent(ev_type, stored, rv)
        # resumable-watch backlog (kept even with zero watchers: a future
        # watch(from_rv=...) may resume across this write); raw refs, so an
        # unwatched write costs zero deepcopies
        ring = self._backlog.get(kind)
        if ring is None:
            ring = self._backlog[kind] = deque()
        if len(ring) >= self._backlog_maxlen:
            old = ring.popleft()
            self._evicted_rv[kind] = old.resource_version
        ring.append(ev)
        # snapshot invalidation: this kind's cached tuples are stale now
        self._snapshots.pop((kind, None), None)
        self._snapshots.pop((kind, ns), None)
        # indexed fan-out: only the two matching buckets, dead watches drop
        # out of the index here (no store-wide linear sweep)
        ev_copy = None
        for bkey in ((kind, None), (kind, ns)):
            bucket = self._watches.get(bkey)
            if not bucket:
                continue
            dead = None
            for w in bucket:
                if w.copy_events:
                    if ev_copy is None:
                        ev_copy = WatchEvent(ev_type, deepcopy_obj(stored), rv)
                    accepted = w._push(ev_copy)
                else:
                    accepted = w._push(ev)
                if not accepted:
                    if dead is None:
                        dead = []
                    dead.append(w)
            if dead:
                for w in dead:
                    bucket.remove(w)
                if not bucket:
                    del self._watches[bkey]
        # amortized BOOKMARK sweep: every bookmark_every writes, lagging
        # watchers (any kind) get an rv checkpoint so an idle informer's
        # resume point keeps up with the global rv even when its own kind
        # sees no traffic
        self._writes_since_bookmark += 1
        if self._writes_since_bookmark >= self._bookmark_every:
            self._writes_since_bookmark = 0
            self._emit_bookmarks_locked(rv)

    def _emit_bookmarks_locked(self, rv: int) -> None:
        bm = WatchEvent(BOOKMARK, None, rv)
        for bucket in list(self._watches.values()):
            for w in list(bucket):
                if w.last_pushed_rv < rv:
                    w._push(bm)
                    self.bookmarks_sent += 1

    def emit_bookmarks(self) -> int:
        """Push a BOOKMARK at the current rv to every lagging watcher
        (callable by a periodic scan for write-idle stores; the write path
        already does this every ``bookmark_every`` writes)."""
        with self._lock:
            before = self.bookmarks_sent
            self._emit_bookmarks_locked(self._rv)
            return self.bookmarks_sent - before

    def close(self) -> None:
        with self._lock:
            watches = [w for bucket in self._watches.values()
                       for w in bucket]
            self._watches.clear()
        for w in watches:
            w.close()
