"""Fair work queue: per-tenant sub-queues + weighted round-robin dispatch.

Paper §III-C: "all tenant informers send the changed objects to a shared
downward FIFO worker queue, which can lead to a well-known queuing unfairness
problem ... we add per tenant sub-queues and use the weighted round-robin
scheduling algorithm to dispatch tenant objects to the downward worker queue.
As a result, none of the tenants would suffer from significant object
synchronization delays, preventing starvation."

The queue keeps client-go dedup semantics globally (a (tenant, key) item that
is queued is never duplicated; an item re-added during processing is
re-queued on done()). With equal weights the dispatch degenerates to plain
round-robin with O(1) dequeue, matching the paper's observation.

``fair=False`` gives the unfair shared FIFO used as the Fig.11 baseline.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Hashable, List, Optional, Tuple

from .workqueue import WakerSubscriptions

Item = Tuple[str, Hashable]   # (tenant, key)


class _SubQueue:
    __slots__ = ("items", "credit")

    def __init__(self) -> None:
        self.items: List[Hashable] = []
        self.credit = 0


class FairWorkQueue(WakerSubscriptions):
    def __init__(self, name: str = "fair", fair: bool = True) -> None:
        self.name = name
        self.fair = fair
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._subs: Dict[str, _SubQueue] = {}
        self._weights: Dict[str, int] = {}
        self._active: List[str] = []      # tenants with nonempty sub-queues
        self._cursor = 0
        self._fifo: List[Item] = []       # unfair mode storage
        self._dirty: set = set()
        self._processing: set = set()
        self._shutdown = False
        # waker depth is PER TENANT sub-queue here: each newly active tenant
        # recruits a consumer (matching WRR's cross-tenant spread), while a
        # same-tenant burst accumulates into real get_batch batches
        self._init_wakers()
        # metrics
        self.added = 0
        self.deduped = 0
        self._enqueue_time: Dict[Item, float] = {}
        self.per_tenant_wait: Dict[str, List[float]] = {}
        # optional UsageMeter: dequeues account queue occupancy (items +
        # summed wait) per tenant. The meter is invoked AFTER releasing
        # ``_cv`` — never under the queue lock — and one attr check per
        # dequeue is the whole cost when unset.
        self.meter: Optional[Any] = None

    # -- tenant management ----------------------------------------------------

    def register_tenant(self, tenant: str, weight: int = 1) -> None:
        with self._lock:
            self._weights[tenant] = max(1, int(weight))
            self._subs.setdefault(tenant, _SubQueue())

    def set_weight(self, tenant: str, weight: int) -> bool:
        """Retune a registered tenant's WRR weight live (autotuning feeds
        per-tenant wait metrics back here). Takes effect at the tenant's
        next credit refill. Returns True when the weight actually changed."""
        weight = max(1, int(weight))
        with self._lock:
            if (tenant not in self._weights
                    or self._weights[tenant] == weight):
                return False
            self._weights[tenant] = weight
            return True

    # safety bound on retained wait samples per tenant: benchmarks read
    # per_tenant_wait between phases (well under this), and the autotuning
    # consumer drains it — the cap only guards deployments running neither
    _WAIT_SAMPLES_CAP = 65_536

    def tenant_wait_stats(self) -> Dict[str, Tuple[int, float]]:
        """Drain and aggregate the per-tenant wait samples recorded since
        the last call: ``{tenant: (n_samples, mean_wait_s)}``. Draining (not
        cursoring) keeps the sample lists bounded for a periodic consumer
        like the autoscaler's autotune tick."""
        out: Dict[str, Tuple[int, float]] = {}
        with self._lock:
            for tenant, samples in self.per_tenant_wait.items():
                if samples:
                    out[tenant] = (len(samples), sum(samples) / len(samples))
            self.per_tenant_wait = {}
        return out

    def drain_tenant(self, tenant: str) -> List[Hashable]:
        """Atomically remove and return every pending key of one tenant
        (shard migration). Pending re-add requests for keys currently being
        processed are claimed too — the migrating caller re-enqueues them on
        the destination queue, so ``done()`` here won't resurrect them."""
        with self._cv:
            out: List[Hashable] = []
            if not self.fair:
                kept: List[Item] = []
                for item in self._fifo:
                    if item[0] == tenant:
                        out.append(item[1])
                    else:
                        kept.append(item)
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
            claimed = set(out)
            for item in [it for it in self._dirty if it[0] == tenant]:
                self._dirty.discard(item)
                if item in self._processing and item[1] not in claimed:
                    out.append(item[1])   # re-add request on an in-flight key
            for key in out:
                self._enqueue_time.pop((tenant, key), None)
            return out

    def unregister_tenant(self, tenant: str) -> None:
        with self._lock:
            self._weights.pop(tenant, None)
            sub = self._subs.pop(tenant, None)
            if tenant in self._active:
                self._active.remove(tenant)
            if sub:
                for k in sub.items:
                    self._dirty.discard((tenant, k))

    # -- producer --------------------------------------------------------------

    def add(self, tenant: str, key: Hashable) -> None:
        item: Item = (tenant, key)
        with self._cv:
            if self._shutdown:
                return
            self.added += 1
            if item in self._dirty:
                self.deduped += 1
                return
            self._dirty.add(item)
            if item in self._processing:
                return
            self._enqueue_time.setdefault(item, time.monotonic())
            if not self.fair:
                self._fifo.append(item)
                depth = len(self._fifo)
            else:
                sub = self._subs.setdefault(tenant, _SubQueue())
                if tenant not in self._weights:
                    self._weights[tenant] = 1
                sub.items.append(key)
                depth = len(sub.items)
                if tenant not in self._active:
                    sub.credit = self._weights[tenant]
                    self._active.append(tenant)
            self._cv.notify()
            self._notify_waker(depth)

    # -- consumer ----------------------------------------------------------------

    def get(self, timeout: Optional[float] = None) -> Optional[Item]:
        with self._cv:
            if not self._wait_for_items(timeout):
                return None
            item = self._fifo.pop(0) if not self.fair else self._wrr_pop_locked()
            wait = self._mark_dequeued(item)
        m = self.meter
        if m is not None:
            m.add_many(item[0], (("queue_items", 1.0),
                                 ("queue_wait_s", wait)))
        return item

    def get_batch(self, max_items: int, timeout: Optional[float] = None
                  ) -> List[Item]:
        """Dequeue up to ``max_items`` items of ONE tenant (burst coalescing).

        The first item follows normal WRR dispatch; the rest drain the same
        tenant's sub-queue. Fairness granularity coarsens from one item to
        one batch (a WRR quantum of ``max_items``) — cross-tenant rotation is
        otherwise preserved. In FIFO mode this is a plain multi-get.
        """
        with self._cv:
            if not self._wait_for_items(timeout):
                return []
            if not self.fair:
                out = [self._fifo.pop(0)]
                wait_sum = self._mark_dequeued(out[0])
                # batches stay single-tenant in FIFO mode too (consumers
                # coalesce per tenant): stop at the first tenant change
                while (self._fifo and len(out) < max_items
                       and self._fifo[0][0] == out[0][0]):
                    item = self._fifo.pop(0)
                    wait_sum += self._mark_dequeued(item)
                    out.append(item)
            else:
                first = self._wrr_pop_locked()
                wait_sum = self._mark_dequeued(first)
                out = [first]
                tenant = first[0]
                sub = self._subs.get(tenant)
                while sub is not None and sub.items and len(out) < max_items:
                    item: Item = (tenant, sub.items.pop(0))
                    wait_sum += self._mark_dequeued(item)
                    out.append(item)
                if sub is not None and not sub.items and tenant in self._active:
                    i = self._active.index(tenant)
                    self._active.pop(i)
                    if i < self._cursor:
                        self._cursor -= 1
        m = self.meter
        if m is not None:
            # batches are single-tenant by construction: one meter round
            m.add_many(out[0][0], (("queue_items", float(len(out))),
                                   ("queue_wait_s", wait_sum)))
        return out

    def _wait_for_items(self, timeout: Optional[float]) -> bool:
        """Block (under ``_cv``) until items exist or shutdown; True if items."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._has_items() and not self._shutdown:
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                return False
            self._cv.wait(remaining)
        return self._has_items()

    def _mark_dequeued(self, item: Item) -> float:
        """Bookkeep a dequeue (under ``_cv``); returns the item's queue wait
        so callers can meter it after releasing the lock."""
        self._dirty.discard(item)
        self._processing.add(item)
        t0 = self._enqueue_time.pop(item, None)
        if t0 is None:
            return 0.0
        wait = time.monotonic() - t0
        samples = self.per_tenant_wait.setdefault(item[0], [])
        samples.append(wait)
        if len(samples) > self._WAIT_SAMPLES_CAP:   # unconsumed: bound it
            del samples[:self._WAIT_SAMPLES_CAP // 2]
        return wait

    def done(self, item: Item) -> None:
        with self._cv:
            self._done_locked(item)

    def done_batch(self, items: List[Item]) -> None:
        """Batch :meth:`done`: ONE lock round for a whole dequeued batch
        (a coalescing consumer otherwise pays a queue lock per item)."""
        with self._cv:
            for item in items:
                self._done_locked(item)

    def _done_locked(self, item: Item) -> None:
        self._processing.discard(item)
        if item in self._dirty:
            # re-add (it was modified while being processed)
            tenant, key = item
            self._enqueue_time.setdefault(item, time.monotonic())
            if not self.fair:
                self._fifo.append(item)
                depth = len(self._fifo)
            else:
                sub = self._subs.setdefault(tenant, _SubQueue())
                sub.items.append(key)
                depth = len(sub.items)
                if tenant not in self._active:
                    sub.credit = self._weights.get(tenant, 1)
                    self._active.append(tenant)
            self._cv.notify()
            self._notify_waker(depth)

    # -- weighted round robin -----------------------------------------------------

    def _wrr_pop_locked(self) -> Item:
        """Pop one item using interleaved WRR over active sub-queues.

        Each active tenant holds ``credit`` (refilled to its weight per round);
        the cursor advances when a tenant's credit is spent. Equal weights
        reduce to plain round-robin (O(1) amortized, paper §IV-A).
        """
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
            key = sub.items.pop(0)
            if not sub.items:
                self._active.pop(self._cursor)
            elif sub.credit <= 0:
                sub.credit = self._weights.get(tenant, 1)
                self._cursor += 1
            return (tenant, key)

    def _has_items(self) -> bool:
        if not self.fair:
            return bool(self._fifo)
        return any(self._subs[t].items for t in self._active)

    def __len__(self) -> int:
        with self._lock:
            if not self.fair:
                return len(self._fifo)
            return sum(len(s.items) for s in self._subs.values())

    def shutdown(self) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()

    def reopen(self) -> None:
        """Accept work again after shutdown() (controller restart)."""
        with self._cv:
            self._shutdown = False
