"""Deduplicating FIFO work queue with client-go semantics.

Invariants (matching k8s.io/client-go/util/workqueue):
- a key added while queued is deduplicated (paper: "the client-go worker queue
  has the capability of deduplicating the incoming requests");
- a key added while being processed is marked dirty and re-queued when its
  processing finishes (never processed concurrently by two workers);
- shutdown drains blocked getters.

Also provides exponential-backoff retry bookkeeping (rate-limited requeue).
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Hashable, List, Optional


class WakerSubscriptions:
    """Readiness subscription shared by every work-queue flavour
    (cooperative executor mode).

    ``subscribe(waker)`` registers an on-ready callback; consumers poll
    with ``get(timeout=0)`` (or ``get_batch(..., timeout=0)``) and park when
    nothing is returned. Producers call ``_notify_waker(depth)`` with their
    pending-item depth — the whole queue, or one tenant sub-queue in fair
    mode — and one subscriber is woken (round-robin) per ``_WAKE_STRIDE``
    pending items: the empty->nonempty edge always wakes (it sustains the
    drain — a woken consumer polls until the queue is empty before parking
    again), the stride recruits extra consumers for bursts without a waker
    round-trip per add, and the in-between silence lets bursts accumulate
    into real dequeue batches.
    """

    _WAKE_STRIDE = 8

    # provided by the concrete queue class mixing this in
    _cv: threading.Condition

    def _init_wakers(self) -> None:
        self._wakers: List[Callable[[], None]] = []
        self._waker_rr = 0
        self.waker_errors = 0    # waker callbacks that raised

    def subscribe(self, waker: Callable[[], None]) -> None:
        with self._cv:
            self._wakers.append(waker)

    def unsubscribe(self, waker: Callable[[], None]) -> None:
        with self._cv:
            try:
                self._wakers.remove(waker)
            except ValueError:
                pass

    def _notify_waker(self, depth: int) -> None:
        # call with _cv held
        if not self._wakers or not (
                depth == 1 or depth % self._WAKE_STRIDE == 0):
            return
        self._waker_rr = (self._waker_rr + 1) % len(self._wakers)
        try:
            self._wakers[self._waker_rr]()
        except Exception:
            # a dying waker must not block producers; count it so a
            # wedged consumer is visible in queue metrics
            self.waker_errors += 1


class WorkQueue(WakerSubscriptions):
    def __init__(self, name: str = "queue") -> None:
        self.name = name
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: List[Hashable] = []
        self._dirty: set = set()
        self._processing: set = set()
        self._shutdown = False
        self._init_wakers()
        # metrics
        self.added = 0
        self.deduped = 0
        self._enqueue_time: Dict[Hashable, float] = {}
        self.queue_latency_sum = 0.0
        self.queue_latency_count = 0

    def add(self, key: Hashable) -> None:
        with self._cv:
            if self._shutdown:
                return
            self.added += 1
            if key in self._dirty:
                self.deduped += 1
                return
            self._dirty.add(key)
            if key in self._processing:
                return  # will re-queue on done()
            self._queue.append(key)
            self._enqueue_time.setdefault(key, time.monotonic())
            self._cv.notify()
            self._notify_waker(len(self._queue))

    def get(self, timeout: Optional[float] = None) -> Optional[Hashable]:
        with self._cv:
            deadline = None if timeout is None else time.monotonic() + timeout
            while not self._queue and not self._shutdown:
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cv.wait(remaining)
            if self._shutdown and not self._queue:
                return None
            key = self._queue.pop(0)
            self._dirty.discard(key)
            self._processing.add(key)
            t0 = self._enqueue_time.pop(key, None)
            if t0 is not None:
                self.queue_latency_sum += time.monotonic() - t0
                self.queue_latency_count += 1
            return key

    def done(self, key: Hashable) -> None:
        with self._cv:
            self._processing.discard(key)
            if key in self._dirty and key not in self._queue:
                self._queue.append(key)
                self._enqueue_time.setdefault(key, time.monotonic())
                self._cv.notify()
                self._notify_waker(len(self._queue))

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()

    def reopen(self) -> None:
        """Accept work again after shutdown() (controller restart)."""
        with self._cv:
            self._shutdown = False

    @property
    def is_shutdown(self) -> bool:
        with self._lock:
            return self._shutdown


class RateLimiter:
    """Per-key exponential backoff (client-go ItemExponentialFailureRateLimiter)."""

    def __init__(self, base: float = 0.005, cap: float = 1.0) -> None:
        self.base, self.cap = base, cap
        self._fail: Dict[Hashable, int] = {}
        self._lock = threading.Lock()

    def when(self, key: Hashable) -> float:
        with self._lock:
            n = self._fail.get(key, 0)
            self._fail[key] = n + 1
            return min(self.cap, self.base * (2 ** n))

    def forget(self, key: Hashable) -> None:
        with self._lock:
            self._fail.pop(key, None)

    def forget_many(self, keys: List[Hashable]) -> None:
        """Batch :meth:`forget`: one lock round for a whole batch."""
        with self._lock:
            for key in keys:
                self._fail.pop(key, None)

    def retries(self, key: Hashable) -> int:
        with self._lock:
            return self._fail.get(key, 0)


class DelayingQueue(WorkQueue):
    """WorkQueue + add_after (used for rate-limited retries).

    Delays run on per-item ``threading.Timer`` threads by default; wiring a
    :class:`~repro_torch.core.executor.CooperativeExecutor` via :meth:`use_executor`
    moves them onto its single shared timer wheel (no thread per delay).
    ``shutdown()`` cancels every pending delay and ``add_after`` on a shut
    queue is a no-op, so stray timers can never re-open a drained queue
    (e.g. during ``resize_shards`` or manager stop)."""

    def __init__(self, name: str = "delaying") -> None:
        super().__init__(name)
        self._timers: List[threading.Timer] = []
        self._handles: List[Any] = []          # executor timer tasks
        self._tlock = threading.Lock()
        self._executor: Optional[Any] = None

    def use_executor(self, executor: Any) -> None:
        """Schedule future delays on ``executor``'s shared timer wheel."""
        with self._tlock:
            self._executor = executor

    def add_after(self, key: Hashable, delay: float) -> None:
        if delay <= 0:
            self.add(key)
            return
        with self._tlock:
            # shutdown() sets the flag BEFORE cancelling under _tlock, so a
            # timer registered here is either seen by that cancel pass or
            # never created — add_after after shutdown is a strict no-op
            if self.is_shutdown:
                return
            ex = self._executor
            if ex is not None:
                self._handles = [h for h in self._handles if h.alive]
                self._handles.append(
                    ex.call_later(delay, lambda: self.add(key),
                                  name=f"{self.name}-delay"))
                return
            t = threading.Timer(delay, self.add, args=(key,))
            t.daemon = True
            self._timers = [x for x in self._timers if x.is_alive()]
            self._timers.append(t)
        t.start()

    def shutdown(self) -> None:
        super().shutdown()    # flag first: concurrent add_after turns no-op
        with self._tlock:
            timers, self._timers = self._timers, []
            handles, self._handles = self._handles, []
        for t in timers:
            t.cancel()
        for h in handles:
            h.cancel()
