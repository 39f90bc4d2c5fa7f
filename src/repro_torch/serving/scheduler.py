"""Per-tenant WRR admission scheduling for engine decode slots.

The data-plane analog of :class:`repro.core.fairqueue.FairWorkQueue`
(paper fig11): engine slots are the contended resource instead of the
downward worker queue, and requests — not object keys — are the items.
``SlotScheduler`` keeps per-tenant sub-queues and dispatches with the same
interleaved weighted-round-robin credit scheme (credits refilled to the
tenant's weight per round, cursor advance on spend), so a greedy tenant's
prompt flood cannot monopolize freed slots while a steady tenant waits.

Differences from the control-plane queue are deliberate:

- ``take(n)`` is **non-blocking** — engines poll for free slots on their
  own drive threads; an admission path must never park a worker.
- No dedup/processing state: every request is a distinct unit of work.
- ``fair=False`` degrades to one shared FIFO, the starvation baseline the
  serving benchmark contrasts against (fig11's unfair case).
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, TYPE_CHECKING, Tuple

if TYPE_CHECKING:   # pragma: no cover - typing only
    from .engine import Request


class _TenantQueue:
    __slots__ = ("items", "credit")

    def __init__(self) -> None:
        self.items: Deque["Request"] = deque()
        self.credit = 0


class SlotScheduler:
    """WRR dispatch of pending requests into freed engine slots."""

    def __init__(self, fair: bool = True) -> None:
        self.fair = fair
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._subs: Dict[str, _TenantQueue] = {}
        self._weights: Dict[str, int] = {}
        self._active: List[str] = []      # tenants with nonempty sub-queues
        self._cursor = 0
        self._fifo: Deque["Request"] = deque()
        # metrics
        self.submitted = 0
        self.dispatched = 0
        self.per_tenant_wait: Dict[str, List[float]] = {}

    # -- tenant management -------------------------------------------------

    def register_tenant(self, tenant: str, weight: int = 1) -> None:
        with self._lock:
            self._weights[tenant] = max(1, int(weight))
            self._subs.setdefault(tenant, _TenantQueue())

    def set_weight(self, tenant: str, weight: int) -> bool:
        """Retune a tenant's WRR weight live; effective at its next credit
        refill. Returns True when the weight actually changed."""
        weight = max(1, int(weight))
        with self._lock:
            if (tenant not in self._weights
                    or self._weights[tenant] == weight):
                return False
            self._weights[tenant] = weight
            return True

    def drain_tenant(self, tenant: str) -> List["Request"]:
        """Atomically remove and return every pending request of one tenant
        (tenant teardown; in-flight slots finish on their own)."""
        with self._lock:
            out: List["Request"] = []
            if not self.fair:
                kept: Deque["Request"] = deque()
                for req in self._fifo:
                    (out if req.tenant == tenant else kept).append(req)
                self._fifo = kept
            else:
                sub = self._subs.get(tenant)
                if sub is not None:
                    out.extend(sub.items)
                    sub.items.clear()
                if tenant in self._active:
                    i = self._active.index(tenant)
                    self._active.pop(i)
                    if i < self._cursor:
                        self._cursor -= 1
            return out

    # -- producer ----------------------------------------------------------

    def submit(self, tenant: str, req: "Request") -> None:
        with self._cv:
            self.submitted += 1
            req.tenant = tenant
            if not self.fair:
                self._fifo.append(req)
            else:
                sub = self._subs.setdefault(tenant, _TenantQueue())
                if tenant not in self._weights:
                    self._weights[tenant] = 1
                sub.items.append(req)
                if tenant not in self._active:
                    sub.credit = self._weights[tenant]
                    self._active.append(tenant)
            self._cv.notify_all()

    # -- consumer ----------------------------------------------------------

    def take(self, n: int) -> List["Request"]:
        """Dequeue up to ``n`` requests by WRR dispatch. Non-blocking: an
        engine calls this with its current free-slot count and admits
        whatever comes back."""
        if n <= 0:
            return []
        out: List["Request"] = []
        now = time.monotonic()
        with self._lock:
            if not self.fair:
                while self._fifo and len(out) < n:
                    out.append(self._fifo.popleft())
            else:
                while len(out) < n and self._active:
                    out.append(self._wrr_pop_locked())
            for req in out:
                req.dequeued_at = now   # queue-wait -> admit boundary
                self.per_tenant_wait.setdefault(req.tenant, []).append(
                    now - req.submitted_at)
            self.dispatched += len(out)
        return out

    def _wrr_pop_locked(self) -> "Request":
        """Pop one request via interleaved WRR (fairqueue semantics): each
        active tenant holds ``credit`` refilled to its weight per round;
        the cursor advances when a tenant's credit is spent."""
        while True:
            if self._cursor >= len(self._active):
                self._cursor = 0
            tenant = self._active[self._cursor]
            sub = self._subs[tenant]
            if not sub.items:
                self._active.pop(self._cursor)
                continue
            if sub.credit <= 0:
                sub.credit = self._weights.get(tenant, 1)
                self._cursor += 1
                continue
            sub.credit -= 1
            req = sub.items.popleft()
            if not sub.items:
                self._active.pop(self._cursor)
            elif sub.credit <= 0:
                sub.credit = self._weights.get(tenant, 1)
                self._cursor += 1
            return req

    # -- introspection -----------------------------------------------------

    def pending(self) -> int:
        with self._lock:
            if not self.fair:
                return len(self._fifo)
            return sum(len(s.items) for s in self._subs.values())

    def pending_by_tenant(self) -> Dict[str, int]:
        with self._lock:
            if not self.fair:
                out: Dict[str, int] = {}
                for req in self._fifo:
                    out[req.tenant] = out.get(req.tenant, 0) + 1
                return out
            return {t: len(s.items) for t, s in self._subs.items()
                    if s.items}

    def tenant_wait_stats(self) -> Dict[str, Tuple[int, float]]:
        """Drain and aggregate queue-wait samples since the last call:
        ``{tenant: (n, mean_wait_s)}`` (periodic metrics consumer)."""
        out: Dict[str, Tuple[int, float]] = {}
        with self._lock:
            for tenant, samples in self.per_tenant_wait.items():
                if samples:
                    out[tenant] = (len(samples),
                                   sum(samples) / len(samples))
            self.per_tenant_wait = {}
        return out

    def notify_all(self) -> None:
        """Wake every thread parked in :meth:`wait_pending` (replica
        retirement: the drive loop must observe its stop flag)."""
        with self._cv:
            self._cv.notify_all()

    def wait_pending(self, timeout: Optional[float] = None) -> bool:
        """Block until work is pending (or timeout). For dedicated engine
        drive threads ONLY — never call from a cooperative-executor task."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cv:
            while self.pending_locked() == 0:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining)
            return True

    def pending_locked(self) -> int:
        if not self.fair:
            return len(self._fifo)
        return sum(len(s.items) for s in self._subs.values())

    def __len__(self) -> int:
        return self.pending()
