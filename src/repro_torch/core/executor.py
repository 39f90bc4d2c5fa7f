"""Shared cooperative executor: one bounded worker pool for the whole
control plane.

The paper's control plane (§III-C) is a crowd of informers, work queues, and
rate-limited workers per controller. Running each of those on its own OS
thread makes thread count O(tenants × informers) — a super-cluster hosting
thousands of tenant control planes would burn thousands of threads before
doing any work, exactly the dedicated-resource waste VirtualCluster exists
to avoid. This module multiplexes all of them onto a fixed-size pool:

- a :class:`Task` is a schedulable unit whose ``fn()`` runs one bounded
  *quantum* (drain a few watch events, reconcile a few keys, one scan pass)
  and then reports what it needs next: :data:`Task.WAIT` (sleep until
  someone calls :meth:`Task.wake`), :data:`Task.AGAIN` (requeue at the tail
  of the ready deque — the cooperative yield), :data:`Task.DONE` (finished),
  or a float (re-run after that many seconds via the timer wheel);
- *wakers* are how blocking waits become readiness callbacks: ``_Watch``
  (informer event pumps) and the work queues (reconcile workers) call
  ``task.wake()`` when new input arrives, so an idle task costs zero
  threads;
- one **timer wheel** (a heap serviced by whichever pool thread wakes
  first) replaces per-item ``threading.Timer`` objects for delayed retries
  and periodic scans.

Scheduling is FIFO over the ready deque with bounded quanta, which gives
starvation freedom: a controller flooding its queue still yields the pool
to every other ready task between quanta. Thread count is O(pool size)
regardless of how many tenants, informers, or workers are registered.

Wakes are never lost: ``wake()`` on a RUNNING task marks it pending and the
executor requeues it when the quantum ends, so the check-then-wait race
between a task observing "no input" and new input arriving is closed by
construction.
"""
from __future__ import annotations

import heapq
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, List, Optional, Set, Tuple

from . import sanitize
from . import trace as _trace


class RetryLater(Exception):
    """Work cannot make progress *yet* (a gate or precondition is
    pending). Controllers listing it in ``retry_on`` requeue the key with
    backoff instead of parking a worker — the cooperative replacement for
    blocking inside ``reconcile``. Defined here (not runtime.py) so leaf
    modules like apiserver.py can raise it without importing the
    controller runtime."""


# Marks pool threads so leaf code (e.g. TokenBucket.take) can refuse to
# block when called from a cooperative quantum without needing a reference
# to the executor instance.
_pool_state = threading.local()


def current_thread_pooled() -> bool:
    """True when the calling thread is a CooperativeExecutor pool thread."""
    return getattr(_pool_state, "active", False)


class Task:
    """One cooperatively scheduled unit of work on a :class:`CooperativeExecutor`.

    ``fn()`` is invoked with no lock held and must return one of the
    sentinels below (or a float delay in seconds). Exceptions from ``fn``
    are counted on the executor and treated as :data:`WAIT` — a broken task
    never kills a pool thread.
    """

    WAIT = object()    # idle until wake()
    AGAIN = object()   # requeue immediately (cooperative yield)
    DONE = object()    # task complete

    _IDLE, _READY, _RUNNING, _DONE = range(4)

    __slots__ = ("name", "fn", "_ex", "_state", "_pending_wake",
                 "_cancelled", "_finished", "trace_ctx")

    def __init__(self, executor: "CooperativeExecutor",
                 fn: Callable[[], Any], name: str):
        self.name = name
        self.fn = fn
        self._ex = executor
        self._state = Task._IDLE
        self._pending_wake = False
        self._cancelled = False
        self._finished = threading.Event()
        # Trace context attaches to the TASK, not the thread: quanta hop
        # pool threads across a WAIT, so thread-locals lie. Inherit the
        # spawner's current span; the executor swaps this in/out around
        # every quantum.
        self.trace_ctx = _trace.current_span()

    @property
    def alive(self) -> bool:
        return self._state != Task._DONE

    def wake(self) -> None:
        """Mark the task ready. Idempotent; safe from any thread; a wake
        during RUNNING re-queues the task after its current quantum."""
        # Lock-free fast path for bursts: READY (a GIL-atomic read) means a
        # whole future quantum is guaranteed, and wakers enqueue input
        # *before* waking, so that quantum's poll will see it. (RUNNING
        # cannot take this shortcut — its final poll may already be past.)
        if self._state == Task._READY:
            return
        with self._ex._cv:
            self._wake_locked()

    def _wake_locked(self) -> None:
        if self._cancelled or self._state in (Task._DONE, Task._READY):
            return
        if self._state == Task._RUNNING:
            self._pending_wake = True
            return
        self._state = Task._READY
        self._ex._ready.append(self)
        self._ex._cv.notify()

    def cancel(self) -> None:
        """Stop the task: immediately if idle/ready, after the current
        quantum if running. Pending timer entries become no-ops."""
        with self._ex._cv:
            if self._state == Task._DONE:
                return
            self._cancelled = True
            if self._state != Task._RUNNING:
                self._finish_locked()

    def join(self, timeout: Optional[float] = None) -> bool:
        return self._finished.wait(timeout)

    def _finish_locked(self) -> None:
        if self._state == Task._DONE:
            return
        self._state = Task._DONE
        self._ex._tasks.discard(self)
        self._finished.set()


class CooperativeExecutor:
    """Bounded pool of OS threads multiplexing :class:`Task` quanta.

    All pool threads share one condition variable guarding the ready deque
    and the timer heap; a sleeping thread bounds its wait by the earliest
    timer deadline, so due timers fire without a dedicated timer thread.
    ``start()`` is idempotent and ``shutdown()`` + ``start()`` restarts with
    fresh threads (controller-manager restart). The pool is **live-resizable**
    (:meth:`resize`): grow spawns threads, shrink retires them at quantum
    boundaries via poison quanta — the autoscaler's vertical actuator.
    """

    def __init__(self, pool_size: int = 8, name: str = "coop"):
        self.name = name
        self.pool_size = max(1, int(pool_size))
        self._cv = threading.Condition()
        self._ready: Deque[Task] = deque()
        self._timers: List[Tuple[float, int, Task]] = []
        self._seq = itertools.count()
        self._thread_seq = itertools.count()
        self._tasks: Set[Task] = set()
        self._threads: List[threading.Thread] = []
        self._retire = 0          # poison quanta owed to surplus threads
        self._stop = False
        # metrics (read via gauges; int updates under _cv)
        self.quanta_total = 0
        self.quanta_seconds = 0.0
        self.task_errors = 0
        self.resizes = 0
        # REPRO_SANITIZE=1: warn when a quantum hogs its pool thread
        # (captured at construction; tests build fresh executors)
        self._sanitize = sanitize.enabled()
        self._sanitize_quantum_s = sanitize.long_quantum_seconds()
        self.long_quanta = 0

    # -- lifecycle ---------------------------------------------------------

    @property
    def running(self) -> bool:
        return bool(self._threads) and not self._stop

    def in_pool_thread(self) -> bool:
        """True when called from one of this executor's pool threads —
        callers use it to avoid blocking waits that only a pool thread
        could satisfy (self-deadlock at small pool sizes)."""
        cur = threading.current_thread()
        with self._cv:
            return cur in self._threads

    def start(self) -> None:
        with self._cv:
            if self._threads and not self._stop:
                return
            self._stop = False
            self._retire = 0
            for i in range(self.pool_size - len(self._threads)):
                self._spawn_thread_locked()

    def _spawn_thread_locked(self) -> None:
        t = threading.Thread(
            target=self._worker_loop,
            name=f"{self.name}-pool-{next(self._thread_seq)}", daemon=True)
        t.start()
        self._threads.append(t)

    def resize(self, n: int) -> int:
        """Live-resize the pool to ``n`` threads; returns the previous size.

        Grow spawns threads immediately. Shrink is drain-and-retire via
        *poison quanta*: surplus threads are owed a retire token and exit at
        their next quantum boundary (never mid-quantum), so no task state is
        lost and parked tasks keep their wakers. Never joins — safe to call
        FROM a pool thread (the autoscaler tick runs on the pool; the caller
        itself may retire once its current quantum ends). Idempotent; a
        stopped executor just records the new size for the next start().
        """
        n = max(1, int(n))
        with self._cv:
            prev = self.pool_size
            self.pool_size = n
            if n != prev:
                self.resizes += 1
            if self._stop or not self._threads:
                return prev       # start() spawns to pool_size
            effective = len(self._threads) - self._retire
            if n > effective:
                reclaim = min(self._retire, n - effective)
                self._retire -= reclaim       # un-poison pending retires
                for _ in range(n - effective - reclaim):
                    self._spawn_thread_locked()
            elif n < effective:
                self._retire += effective - n
                self._cv.notify_all()         # sleepers must see the poison
            return prev

    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop the pool. Idle/ready tasks are finished immediately; a task
        mid-quantum completes its quantum on its (daemon) thread."""
        with self._cv:
            self._stop = True
            # threads exit via the _stop check without consuming pending
            # poison; clear it so thread_count() can't go negative
            self._retire = 0
            for task in list(self._tasks):
                task._cancelled = True
                if task._state != Task._RUNNING:
                    task._finish_locked()
            self._cv.notify_all()
            threads = list(self._threads)
        for t in threads:
            t.join(timeout)
        with self._cv:
            self._threads = [t for t in self._threads if t.is_alive()]

    # -- scheduling --------------------------------------------------------

    def spawn(self, fn: Callable[[], Any], name: str = "task", *,
              delay: Optional[float] = None, defer: bool = False) -> Task:
        """Register a task. Ready immediately by default; ``delay`` arms the
        timer wheel instead; ``defer`` leaves it idle until ``wake()`` (so
        the caller can publish the task handle before the first quantum)."""
        task = Task(self, fn, name)
        with self._cv:
            if self._stop:
                # shutdown race (e.g. a retry timer firing during teardown):
                # return an already-finished no-op handle
                task._cancelled = True
                task._state = Task._DONE
                task._finished.set()
                return task
            self._tasks.add(task)
            if delay is not None:
                self._arm_locked(task, delay)
            elif not defer:
                task._state = Task._READY
                self._ready.append(task)
                self._cv.notify()
        return task

    def call_later(self, delay: float, fn: Callable[[], None],
                   name: str = "timer") -> Task:
        """One-shot timer on the shared wheel; cancel via the returned task.
        ``fn`` runs on a pool thread with no executor lock held."""
        def once() -> Any:
            fn()
            return Task.DONE
        return self.spawn(once, name=name, delay=max(0.0, float(delay)))

    def _arm_locked(self, task: Task, delay: float) -> None:
        heapq.heappush(self._timers,
                       (time.monotonic() + max(0.0, float(delay)),
                        next(self._seq), task))
        self._cv.notify()   # a sleeper may need to shorten its wait

    # -- introspection (metrics gauges) ------------------------------------

    def ready_backlog(self) -> int:
        with self._cv:
            return len(self._ready)

    def timer_depth(self) -> int:
        with self._cv:
            return len(self._timers)

    def task_count(self) -> int:
        with self._cv:
            return len(self._tasks)

    def thread_count(self) -> int:
        """Live pool threads, retiring ones excluded (converges to
        ``pool_size`` after a resize)."""
        with self._cv:
            return len(self._threads) - self._retire

    # -- pool --------------------------------------------------------------

    def _worker_loop(self) -> None:
        _pool_state.active = True
        while True:
            task: Optional[Task] = None
            with self._cv:
                while task is None:
                    if self._stop:
                        return
                    if self._retire > 0:
                        # poison quantum: retire this thread. Hand any wake
                        # we may have absorbed to a surviving sleeper so a
                        # shrink can never strand a ready task.
                        self._retire -= 1
                        try:
                            self._threads.remove(threading.current_thread())
                        except ValueError:
                            pass
                        if self._ready:
                            self._cv.notify()
                        return
                    now = time.monotonic()
                    while self._timers and self._timers[0][0] <= now:
                        _, _, due = heapq.heappop(self._timers)
                        due._wake_locked()   # no-op if cancelled/done/ready
                    if self._ready:
                        cand = self._ready.popleft()
                        if cand._state != Task._READY:
                            continue         # cancelled while queued
                        cand._state = Task._RUNNING
                        task = cand
                        break
                    timeout = None
                    if self._timers:
                        timeout = max(0.0, self._timers[0][0] - now)
                    self._cv.wait(timeout)
            self._run_quantum(task)

    def _run_quantum(self, task: Task) -> None:
        t0 = time.monotonic()
        # install the task's trace context for this quantum and save
        # whatever it left current (spans may stay open across a WAIT)
        prev_ctx = _trace.swap_current(task.trace_ctx)
        try:
            result = task.fn()
            failed = False
        except BaseException:   # vclint: disable=VCL004 counted as task_errors below
            result = Task.WAIT
            failed = True
        finally:
            task.trace_ctx = _trace.swap_current(prev_ctx)
        dur = time.monotonic() - t0
        if self._sanitize and dur > self._sanitize_quantum_s:
            sanitize.report_long_hold(
                f"task {task.name!r} quantum ran {dur * 1e3:.0f}ms "
                f"(> {self._sanitize_quantum_s * 1e3:.0f}ms) on "
                f"executor {self.name!r}")
        with self._cv:
            if self._sanitize and dur > self._sanitize_quantum_s:
                self.long_quanta += 1
            self.quanta_total += 1
            self.quanta_seconds += dur
            if failed:
                self.task_errors += 1
            if task._cancelled or result is Task.DONE:
                task._finish_locked()
                return
            task._state = Task._IDLE
            if task._pending_wake or result is Task.AGAIN:
                task._pending_wake = False
                task._state = Task._READY
                self._ready.append(task)
                self._cv.notify()
            elif isinstance(result, (int, float)):
                self._arm_locked(task, float(result))
            # else Task.WAIT: idle until wake()
