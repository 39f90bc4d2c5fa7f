"""The centralized resource syncer (paper §III-C, Fig.5), sharded by tenant.

One syncer serves many tenant control planes. Per tenant, per synced kind, a
tenant-side informer feeds a **downward** fair work queue (per-tenant
sub-queues + WRR dispatch); a super-side informer feeds the **upward** work
queue. Per-resource reconcilers perform:

- downward synchronization: tenant spec -> super cluster (namespace-prefixed);
- upward synchronization: super status -> tenant control plane (vNode-mapped).

Scaling beyond the paper, the downward path is **sharded by tenant UID over
a consistent-hash ring** (``ring_vnodes`` virtual nodes per shard): ``shards``
independent :class:`~repro_torch.core.runtime.Controller` workers each own a
per-shard fair queue serving the tenants that hash onto them. Every tenant
deterministically lands on one shard (stable across restarts), growing the
fleet via :meth:`Syncer.resize_shards` live-migrates only ~1/N of the
tenants, per-shard WRR preserves the Fig.11 fairness guarantees, and
same-tenant bursts are coalesced into batches (``downward_batch``) covering
the full CRUD surface — batched creates, spec updates, AND deletes — issued
through a per-shard super-API client (dedicated token bucket), so shards
never serialize on one bucket lock.

The upward path mirrors it (see :mod:`repro_torch.core.upward`): tenant-hash
**upward shards** on their own consistent-hash ring, each with a per-tenant
fair queue and its own super-API client, per-object latest-wins status
coalescing, and batched tenant-plane writes (``batch_upward``, on by
default); :class:`~repro_torch.core.objects.Event` objects recorded in the super
cluster are synced upward with their dedup counts so tenants can list their
own events.

State comparisons are made against informer caches, never the apiservers.
A periodic scan remediates rare permanently-inconsistent states by re-sending
objects to the worker queues (paper: "significantly reduces the complexity of
recovering inconsistencies caused by various rare reasons").

Defaults follow the paper: 20 downward workers (split across shards), 100
upward workers (split across upward shards), 60 s scan interval, one shard
per direction. Passing ``executor=`` runs every shard/scan controller — and
all tenant informer pumps, the ``resize_shards`` handover included — as
tasks on that shared :class:`~repro_torch.core.executor.CooperativeExecutor`
instead of dedicated threads (thread count O(pool) instead of
O(tenants × kinds)).
"""
from __future__ import annotations

import hashlib
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from .apiserver import APIServer, TenantControlPlane
from .fairqueue import FairWorkQueue
from .informer import Informer
from .metering import obj_nbytes
from .objects import (SYNCED_KINDS_DOWNWARD, SYNCED_KINDS_UPWARD, Namespace,
                      deepcopy_obj, obj_kind, spec_equal, status_equal)
from .ring import ShardRing, shard_for  # noqa: F401  (re-export: public API)
from .runtime import Controller, MetricsRegistry, RetryLater
from .trace import TRACEPARENT_KEY, sampled_carrier
from .store import (ADDED, MODIFIED, AlreadyExistsError, ConflictError,
                    NotFoundError)
from .upward import UpwardPipeline
from .vnode import VNodeManager

DownItem = Tuple[str, str, str]        # (kind, tenant_ns, name) under a tenant
UpItem = Tuple[str, str, str]          # (kind, super_ns, name)


def ns_prefix(vc_name: str, vc_uid: str) -> str:
    """Paper §III-B (2): prefix = VC object name + short hash of its UID."""
    h = hashlib.sha256(vc_uid.encode()).hexdigest()[:6]
    return f"{vc_name}-{h}"


@dataclass
class UnitTimeline:
    """Per-WorkUnit phase timestamps for the Fig.8 breakdown."""
    tenant_create: float = 0.0
    dws_enqueue: float = 0.0
    dws_dequeue: float = 0.0
    dws_done: float = 0.0
    super_ready: float = 0.0
    uws_enqueue: float = 0.0
    uws_dequeue: float = 0.0
    uws_done: float = 0.0

    def phases(self) -> Dict[str, float]:
        return {
            "DWS-Queue": max(0.0, self.dws_dequeue - self.dws_enqueue),
            "DWS-Process": max(0.0, self.dws_done - self.dws_dequeue),
            "Super-Sched": max(0.0, self.super_ready - self.dws_done),
            "UWS-Queue": max(0.0, self.uws_dequeue - self.uws_enqueue),
            "UWS-Process": max(0.0, self.uws_done - self.uws_dequeue),
        }

    @property
    def complete(self) -> bool:
        return self.uws_done > 0 and self.dws_enqueue > 0


@dataclass
class SyncerMetrics:
    timelines: Dict[Tuple[str, str, str], UnitTimeline] = field(default_factory=dict)
    downward_syncs: int = 0
    upward_syncs: int = 0
    scan_fixes: int = 0
    scan_runs: int = 0
    scan_duration_sum: float = 0.0
    events_expired: int = 0
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def timeline(self, tenant: str, ns: str, name: str) -> UnitTimeline:
        key = (tenant, ns, name)
        with self._lock:
            tl = self.timelines.get(key)
            if tl is None:
                tl = self.timelines[key] = UnitTimeline()
            return tl

    # Counters are bumped from many worker threads; bare += would lose
    # increments (read-modify-write race), so all increments go through here.

    def inc_downward(self, n: int = 1) -> None:
        with self._lock:
            self.downward_syncs += n

    def inc_upward(self, n: int = 1) -> None:
        with self._lock:
            self.upward_syncs += n

    def inc_scan(self, fixes: int, duration: float) -> None:
        with self._lock:
            self.scan_runs += 1
            self.scan_fixes += fixes
            self.scan_duration_sum += duration

    def inc_events_expired(self, n: int) -> None:
        with self._lock:
            self.events_expired += n


class TenantRegistration:
    """Everything the syncer holds per tenant."""

    def __init__(self, plane: TenantControlPlane, prefix: str,
                 shard: "_DownwardShard", uid: str = "",
                 upward_shard: Optional[Any] = None):
        self.plane = plane
        self.prefix = prefix
        self.shard = shard     # current owning downward shard; swaps on resize
        self.upward_shard = upward_shard   # current owning upward shard
        self.uid = uid or plane.name
        self.informers: Dict[str, Informer] = {}
        # super namespaces already ensured for this tenant (coalesces the
        # per-item existence probe before super-cluster writes)
        self.ensured_ns: set = set()
        self.ensured_lock = threading.Lock()


class _DownwardShard(Controller):
    """One downward shard: a per-shard fair queue + workers for the tenants
    hashed onto it. Retries Conflict/AlreadyExists (informer-cache races).

    Each shard talks to the super cluster through its OWN ``APIClient``
    (dedicated token bucket over the shared store), so batched writes from
    different shards never serialize on one bucket lock.
    """

    def __init__(self, syncer: "Syncer", shard_id: int, *, workers: int,
                 fair: bool, batch_size: int):
        super().__init__(f"syncer-dws-{shard_id}",
                         queue=FairWorkQueue(f"downward-{shard_id}", fair=fair),
                         workers=workers, batch_size=batch_size,
                         retry_on=(ConflictError, AlreadyExistsError,
                                   RetryLater),
                         drop_on=())
        self.syncer = syncer
        self.shard_id = shard_id
        self.api = syncer.super_api.client(f"dws-{shard_id}")
        # shards created after wiring (resize) inherit the live meter
        self.queue.meter = syncer._meter

    def _retry_queue(self, item: Any) -> Any:
        """Retries re-enter the tenant's CURRENT shard: if resize_shards
        migrated the tenant while this item was in flight, re-adding to our
        own (drained, possibly about-to-stop) queue would strand the key."""
        reg = self.syncer.tenants.get(item[0])   # GIL-atomic dict read
        return reg.shard.queue if reg is not None else self.queue

    def reconcile(self, item: Any) -> None:
        tenant, (kind, ns, name) = item
        sy = self.syncer
        tl = None
        if kind == "WorkUnit":
            tl = sy.metrics.timeline(tenant, ns, name)
            if tl.dws_dequeue == 0.0:
                tl.dws_dequeue = time.time()
        sy._reconcile_down(tenant, kind, ns, name, api=self.api)
        # stamped only on success: a raise above means the item is retried,
        # and a finally-stamp would make fig7/fig8 undercount retried syncs
        if tl is not None and tl.dws_done == 0.0:
            tl.dws_done = time.time()

    def reconcile_batch(self, items: List[Any]) -> None:
        """Coalesce a same-tenant burst: cache-based state comparison plus
        batched super-cluster writes over the full CRUD surface (creates,
        spec updates, deletes); leftovers (Namespace objects, cache races)
        take the authoritative per-item path."""
        if len(items) == 1:
            return self._reconcile_one(items[0])
        tenant = items[0][0]
        now = time.time()
        for _, (kind, ns, name) in items:
            if kind == "WorkUnit":
                tl = self.syncer.metrics.timeline(tenant, ns, name)
                if tl.dws_dequeue == 0.0:
                    tl.dws_dequeue = now
        t0 = time.monotonic()
        try:
            fast, slow = self.syncer._reconcile_down_fast(
                tenant, [key for _, key in items], api=self.api)
        except Exception:
            # fast path failed as a unit; fall back to per-item reconciles
            # below, but surface the failure in metrics
            self.metrics.inc("fast_path_errors", controller=self.name)
            fast, slow = [], [key for _, key in items]
        dur = time.monotonic() - t0
        done = time.time()
        fast_items = []
        for key in fast:
            fast_items.append((tenant, key))
            kind, ns, name = key
            if kind == "WorkUnit":
                tl = self.syncer.metrics.timeline(tenant, ns, name)
                if tl.dws_done == 0.0:
                    tl.dws_done = done
        if fast_items:
            # batch the bookkeeping too: one lock round each instead of a
            # limiter + two metric + one queue lock round PER KEY
            self.limiter.forget_many(fast_items)
            self.metrics.inc("reconcile_total", float(len(fast_items)),
                             controller=self.name)
            self.metrics.observe_n("reconcile_seconds", dur / len(items),
                                   n=len(fast_items), controller=self.name)
            self.queue.done_batch(fast_items)
        for key in slow:
            self._reconcile_one((tenant, key))


class _ScanController(Controller):
    """Queue-less controller driving the periodic remediation scan."""

    def __init__(self, syncer: "Syncer", interval: float):
        super().__init__("syncer-scan", queue=None, workers=0,
                         scan_interval=interval)
        self.syncer = syncer

    def scan(self) -> int:
        return self.syncer.scan_once()


class Syncer:
    """Facade over the downward shard / upward / scan controllers.

    Public API is unchanged from the single-queue implementation; ``shards``
    and ``downward_batch`` add horizontal scale. Controllers are exposed via
    ``.controllers`` so a cluster-wide ControllerManager can own them; the
    ``start()``/``stop()`` methods remain for standalone use.
    """

    def __init__(self, super_api: APIServer, *,
                 downward_workers: int = 20,
                 upward_workers: int = 100,
                 fair_queuing: bool = True,
                 scan_interval: float = 60.0,
                 batch_upward: bool = True,
                 shards: int = 1,
                 downward_batch: int = 1,
                 upward_shards: Optional[int] = None,
                 upward_batch: int = 16,
                 record_events: bool = True,
                 event_ttl: float = 3600.0,
                 ring_vnodes: int = 64,
                 executor: Optional[Any] = None,
                 informer_cache_budget: Optional[int] = None,
                 tracer: Optional[Any] = None):
        self.super_api = super_api
        # optional Tracer: sync paths record spans for objects carrying a
        # traceparent annotation; every hook guards on `is not None`, so a
        # tracer-less syncer is byte-identical in behavior
        self.tracer = tracer
        # optional SLOTracker (set by the framework): the upward pipeline
        # feeds the end-to-end propagation latency into it
        self.slo: Optional[Any] = None
        # optional UsageMeter (set via the `meter` property, which also
        # propagates to every shard queue): sync lanes account per-tenant
        # items/bytes, queues account occupancy. None = zero-cost guards.
        self._meter: Optional[Any] = None
        # per-informer cache byte budget for tenant-side informers (None =
        # unbounded); evicted keys read through the apiserver on access
        self.informer_cache_budget = informer_cache_budget
        # shared CooperativeExecutor: informer pumps, workers, and the scan
        # run as tasks on its bounded pool; None = legacy one-thread-per-loop
        self.executor = executor
        # optional owning ControllerManager: resize_shards keeps its
        # controller list in sync (health map + stop cover resized shards)
        self.manager: Optional[Any] = None
        self.downward_workers = downward_workers
        self.upward_workers = upward_workers
        self.fair_queuing = fair_queuing
        self.scan_interval = scan_interval
        self.batch_upward = batch_upward
        self.num_shards = max(1, int(shards))
        self.downward_batch = max(1, int(downward_batch))
        self.upward_batch = max(1, int(upward_batch))
        self.ring_vnodes = max(1, int(ring_vnodes))
        self.ring = ShardRing(self.num_shards, self.ring_vnodes)
        self._resize_lock = threading.Lock()
        self.metrics = SyncerMetrics()
        # k8s-style event TTL: the periodic scan expires Events whose
        # last_timestamp is older than this (0 disables the sweep)
        self.event_ttl = float(event_ttl)
        self.vnodes = VNodeManager(record_events=record_events)
        self.tenants: Dict[str, TenantRegistration] = {}
        self._tenants_lock = threading.Lock()
        # reverse map: super_ns -> (tenant, tenant_ns); rebuilt from prefixes
        self._ns_map: Dict[str, Tuple[str, str]] = {}
        self._ns_lock = threading.Lock()

        registry = MetricsRegistry()
        per_shard = max(1, downward_workers // self.num_shards)
        self.shard_controllers: List[_DownwardShard] = [
            _DownwardShard(self, i, workers=per_shard, fair=fair_queuing,
                           batch_size=self.downward_batch)
            for i in range(self.num_shards)]
        # upward fleet: defaults to the downward shard count, with the
        # upward worker budget split across shards; batch_upward=False keeps
        # the per-item path (the benchmark baseline)
        self.upward = UpwardPipeline(
            self,
            shards=(upward_shards if upward_shards is not None
                    else self.num_shards),
            total_workers=upward_workers, fair=fair_queuing,
            batch_size=self.upward_batch if batch_upward else 1,
            ring_vnodes=self.ring_vnodes)
        self.controllers: List[Controller] = (
            list(self.shard_controllers) + list(self.upward.controllers))
        if scan_interval > 0:
            self.controllers.append(_ScanController(self, scan_interval))
        for c in self.controllers:
            c.metrics = registry
            c.executor = executor

        # Super-side informers for every synced kind: upward kinds feed the
        # upward shards; the rest exist so the downward fast lane can make
        # informer-cache state comparisons (paper §III-C) instead of per-item
        # apiserver gets. All attach to upward shard 0 (which never retires,
        # so upward resizes need no informer handover).
        self._super_informers: Dict[str, Informer] = {}
        upward = set(SYNCED_KINDS_UPWARD)
        for kind in (upward | set(SYNCED_KINDS_DOWNWARD) | {"Node"}) - {"Namespace"}:
            handler = None
            if kind == "Node":
                handler = self._node_handler
            elif kind in upward:
                handler = self._super_handler(kind)
            self._super_informers[kind] = self.up_controller.add_informer(
                self.super_api, kind, handler=handler, name=f"super/{kind}")

    # ------------------------------------------------------------------ setup

    @property
    def up_controller(self) -> Controller:
        """Upward shard 0 (back-compat handle; also the shared registry
        holder — every syncer controller carries the same ``metrics``)."""
        return self.upward.controllers[0]

    @property
    def num_upward_shards(self) -> int:
        return self.upward.num_shards

    @property
    def upward_controllers(self) -> List[Controller]:
        return list(self.upward.controllers)

    @property
    def up_queue(self) -> FairWorkQueue:
        """Upward shard 0's queue (the only one when ``upward_shards == 1``)."""
        return self.up_controller.queue

    @property
    def down_queue(self) -> FairWorkQueue:
        """Shard 0's queue (the only queue when ``shards == 1``)."""
        return self.shard_controllers[0].queue

    def shard_for(self, tenant_uid: str) -> int:
        return self.ring.shard_for(tenant_uid)

    def register_tenant(self, plane: TenantControlPlane, vc_uid: str = "") -> str:
        uid = vc_uid or plane.name
        prefix = ns_prefix(plane.name, uid)
        with self._resize_lock:
            shard = self.shard_controllers[self.ring.shard_for(uid)]
            up_shard = self.upward.shard_for_uid(uid)
            reg = TenantRegistration(plane, prefix, shard, uid,
                                     upward_shard=up_shard)
            with self._tenants_lock:
                self.tenants[plane.name] = reg
            shard.queue.register_tenant(plane.name, plane.weight)
            up_shard.queue.register_tenant(plane.name, plane.weight)
            # Declare ALL informers into reg.informers BEFORE starting any:
            # a started informer's initial replay enqueues keys immediately,
            # and a worker reconciling one must find every reg.informers
            # entry populated (an unstarted informer just has an unsynced
            # cache, which reconcile treats as "retry later").
            for kind in SYNCED_KINDS_DOWNWARD:
                inf = Informer(plane.api, kind, name=f"{plane.name}/{kind}",
                               cache_budget_bytes=self.informer_cache_budget)
                inf.add_handler(self._tenant_handler(plane.name, kind))
                reg.informers[kind] = inf
            for inf in reg.informers.values():
                shard.attach_informer(inf)
        return prefix

    def unregister_tenant(self, tenant: str) -> None:
        # under the resize lock: a concurrent resize_shards must not migrate
        # (re-register + re-enqueue) a tenant that is being torn down
        with self._resize_lock:
            with self._tenants_lock:
                reg = self.tenants.pop(tenant, None)
            if reg is None:
                return
            for inf in reg.informers.values():
                reg.shard.remove_informer(inf)
            reg.shard.queue.unregister_tenant(tenant)
            reg.upward_shard.queue.drain_tenant(tenant)
            reg.upward_shard.queue.unregister_tenant(tenant)
        # remove the tenant's synced objects from the super cluster
        # (match by the tenant's namespace prefix — the registration is
        # already popped, so the reverse map may not resolve anymore).
        # Events recorded against the tenant's objects live only in super
        # namespaces, so they are swept here too.
        prefix = reg.prefix + "-"
        for kind in ["Event"] + list(reversed(SYNCED_KINDS_DOWNWARD)):
            # paged, zero-copy sweep: only metadata is read before delete
            objs, _rv = self.super_api.list_all_pages(kind, copy=False)
            for obj in objs:
                ns = (obj.metadata.name if kind == "Namespace"
                      else obj.metadata.namespace)
                if ns.startswith(prefix):
                    try:
                        self.super_api.delete(kind, obj.metadata.namespace,
                                              obj.metadata.name)
                    except NotFoundError:
                        pass

    def start(self) -> None:
        for c in self.controllers:
            c.start()

    def stop(self) -> None:
        for c in reversed(self.controllers):
            c.stop()

    @property
    def meter(self) -> Optional[Any]:
        """Optional :class:`~repro_torch.core.metering.UsageMeter`. Assigning
        propagates to every live shard queue (downward + upward); shards
        created by a later resize inherit it at construction."""
        return self._meter

    @meter.setter
    def meter(self, m: Optional[Any]) -> None:
        self._meter = m
        for c in self.shard_controllers:
            c.queue.meter = m
        for uc in self.upward.controllers:
            uc.queue.meter = m

    # --------------------------------------------------------------- resizing

    def resize_shards(self, n: int, *,
                      block: bool = True) -> Optional[Dict[str, int]]:
        """Live-resize the downward shard fleet to ``n`` shards.

        The consistent-hash ring guarantees only ~1/N of the tenants change
        shard. Each moved tenant is migrated without dropping work: it is
        registered on the destination fair queue (same WRR weight), event
        routing flips to the new shard, the old sub-queue is drained into the
        destination, and its informers are handed over WITHOUT stopping their
        reflectors. Returns ``{tenant: new_shard_id}`` for the movers.

        Concurrent callers (autoscaler tick vs. operator call) serialize on
        the resize lock and the call is idempotent — a resize to the current
        count is a no-op ``{}``, and the loser of a race simply re-resizes
        from whatever fleet the winner left. ``block=False`` (the autoscaler
        path, which runs ON a pool thread and must never park behind an
        operator's in-flight resize or registration) returns ``None``
        without resizing when the lock is contended.

        When the syncer's controllers are owned by a ControllerManager
        (``self.manager``, wired by ``VirtualClusterFramework``), shards
        added/removed here are also added/removed there, so the manager's
        health map and stop cover the resized fleet.
        """
        n = max(1, int(n))
        if not self._resize_lock.acquire(blocking=block):
            return None
        try:
            return self._resize_shards_locked(n)
        finally:
            self._resize_lock.release()

    def resize_upward_shards(self, n: int, *,
                             block: bool = True) -> Optional[Dict[str, int]]:
        """Live-resize the UPWARD shard fleet to ``n`` shards.

        Same contract as :meth:`resize_shards` — consistent-hash ring
        (~1/N tenants move), WRR weights preserved, pending keys drained to
        the destination queue, idempotent no-op ``{}`` at the current count,
        ``block=False`` returns ``None`` on a contended resize lock (the
        autoscaler's third actuator runs on a pool thread). Upward shards
        carry no per-tenant informers (super informers are shared and live
        on shard 0, which never retires), so migration is queue-only.
        """
        n = max(1, int(n))
        if not self._resize_lock.acquire(blocking=block):
            return None
        try:
            return self.upward.resize_locked(n)
        finally:
            self._resize_lock.release()

    def _resize_shards_locked(self, n: int) -> Dict[str, int]:
        if n == self.num_shards:
            return {}
        registry = self.up_controller.metrics
        running = any(c.running for c in self.shard_controllers)
        # new shards match the existing per-shard worker count so the
        # fleet stays uniform (growing the fleet grows total capacity;
        # sizing new shards to downward_workers // n would leave old
        # shards with several times the workers of their peers)
        per_shard = self.shard_controllers[0].workers
        while len(self.shard_controllers) < n:
            i = len(self.shard_controllers)
            c = _DownwardShard(self, i, workers=per_shard,
                               fair=self.fair_queuing,
                               batch_size=self.downward_batch)
            c.metrics = registry
            c.executor = self.executor
            self.shard_controllers.append(c)
            self.controllers.append(c)
            if running:
                c.start()   # must run before tenants route onto it
            if self.manager is not None:
                self.manager.add(c)   # start() above is idempotent
        new_ring = ShardRing(n, self.ring_vnodes)
        with self._tenants_lock:
            regs = list(self.tenants.values())
        moved: Dict[str, int] = {}
        for reg in regs:
            target = new_ring.shard_for(reg.uid)
            if target == reg.shard.shard_id:
                continue
            self._migrate_tenant(reg, self.shard_controllers[target])
            moved[reg.plane.name] = target
        self.ring = new_ring
        self.num_shards = n
        if len(self.shard_controllers) > n:   # shrink: now-empty shards
            for c in self.shard_controllers[n:]:
                c.stop()
                self.controllers.remove(c)
                if self.manager is not None:
                    self.manager.remove(c)
            del self.shard_controllers[n:]
        return moved

    def _migrate_tenant(self, reg: TenantRegistration,
                        new_shard: _DownwardShard) -> None:
        old_shard = reg.shard
        tenant = reg.plane.name
        new_shard.queue.register_tenant(tenant, reg.plane.weight)
        reg.shard = new_shard       # event handlers resolve the queue via reg
        pending = old_shard.queue.drain_tenant(tenant)
        old_shard.queue.unregister_tenant(tenant)
        for key in pending:
            new_shard.queue.add(tenant, key)
        for inf in reg.informers.values():
            old_shard.detach_informer(inf)
            new_shard.attach_informer(inf)
        # A handler that read reg.shard just before the swap may have
        # added to the old queue after the drain — auto-re-registering the
        # tenant there as a ghost. The handler's re-check routes the item
        # to the new queue too (dedup makes the double add harmless), so
        # this second drain+unregister only clears the ghost entry.
        old_shard.queue.drain_tenant(tenant)
        old_shard.queue.unregister_tenant(tenant)

    # ------------------------------------------------------------ event handlers

    def _tenant_handler(self, tenant: str, kind: str):
        def handler(ev_type: str, obj: Any) -> None:
            ns, name = obj.metadata.namespace, obj.metadata.name
            if kind == "WorkUnit" and ev_type == ADDED:
                tl = self.metrics.timeline(tenant, ns, name)
                if tl.dws_enqueue == 0.0:
                    tl.tenant_create = obj.metadata.creation_timestamp
                    tl.dws_enqueue = time.time()
            # Resolve the owning shard at event time, not at registration:
            # resize_shards may have migrated the tenant since. Lock-free
            # dict read (GIL-atomic) — this is the per-event hot path.
            # If a migration races the add (the old queue may already be
            # drained or even shut down), re-add on the new shard; the
            # destination queue dedups, so a double add is harmless.
            while True:
                reg = self.tenants.get(tenant)
                if reg is None:
                    return
                shard = reg.shard
                shard.queue.add(tenant, (kind, ns, name))
                if reg.shard is shard:
                    return
        return handler

    def _super_handler(self, kind: str):
        def handler(ev_type: str, obj: Any) -> None:
            self.upward.enqueue(kind, obj.metadata.namespace,
                                obj.metadata.name)
            if kind == "WorkUnit":
                t = self._resolve_super_ns(obj.metadata.namespace)
                if t is not None and t[0]:
                    tl = self.metrics.timeline(t[0], t[1], obj.metadata.name)
                    if tl.uws_enqueue == 0.0:
                        tl.uws_enqueue = time.time()
                    if (tl.super_ready == 0.0 and obj.kind == "WorkUnit"
                            and obj.status.phase == "Ready"):
                        tl.super_ready = time.time()
                        tl.uws_enqueue = tl.super_ready
        return handler

    def _node_handler(self, ev_type: str, node: Any) -> None:
        if ev_type in (ADDED, MODIFIED):
            with self._tenants_lock:
                tenants = {t: r.plane for t, r in self.tenants.items()}
            self.vnodes.broadcast_heartbeat(tenants, node)

    # ------------------------------------------------------------- reconcilers

    def _reconcile_down(self, tenant: str, kind: str, ns: str, name: str,
                        api: Optional[Any] = None) -> None:
        """Tenant spec is the source of truth -> project into the super cluster.

        ``api`` is the caller's super-cluster client (a shard's dedicated
        handle); defaults to the shared server client.
        """
        api = api or self.super_api
        tr = self.tracer
        t0 = time.monotonic() if tr is not None else 0.0
        with self._tenants_lock:
            reg = self.tenants.get(tenant)
        if reg is None:
            return
        tenant_inf = reg.informers.get(kind)
        if tenant_inf is None:
            # registration still in flight: requeue with backoff instead of
            # dropping the key (a drop would orphan the object until the
            # next scan — forever when scans are disabled)
            raise RetryLater(f"{tenant}/{kind} informer not registered yet")
        tenant_obj = tenant_inf.cache.get(ns, name)
        if tenant_obj is None and not tenant_inf.wait_for_cache_sync(0):
            # an unsynced cache cannot confirm absence — deleting downstream
            # off it would tear down live objects during informer (re)start
            raise RetryLater(f"{tenant}/{kind} cache not synced yet")
        super_ns = self._translate_ns(reg, ns)
        if kind == "Namespace":
            super_ns_name = self._translate_ns(reg, name)
            if tenant_obj is None:
                self._delete_super("Namespace", "", super_ns_name, api=api)
                with reg.ensured_lock:
                    reg.ensured_ns.discard(super_ns_name)
            else:
                self._ensure_super_namespace(reg, super_ns_name, tenant, name,
                                             api=api)
            return

        if tenant_obj is None:
            # deleted in tenant -> delete downstream
            try:
                api.get(kind, super_ns, name)
            except NotFoundError:
                return
            self._delete_super(kind, super_ns, name, api=api)
            if kind == "WorkUnit":
                self.vnodes.unbind(reg.plane, ns, name)
            self.metrics.inc_downward()
            m = self._meter
            if m is not None:
                m.add(tenant, "down_items", 1.0)
            return

        self._ensure_super_namespace(reg, super_ns, tenant, ns, api=api)
        projected = self._project_down(tenant_obj, tenant, ns, super_ns)
        try:
            existing = api.get(kind, super_ns, name)
        except NotFoundError:
            try:
                api.create(projected)
                self.metrics.inc_downward()
                m = self._meter
                if m is not None:
                    m.add_many(tenant, (("down_items", 1.0),
                                        ("down_bytes",
                                         float(obj_nbytes(projected)))))
                self._trace_down(tenant_obj, t0, tenant, kind, ns, name)
            except AlreadyExistsError:
                pass
            return
        if not _spec_equal(projected, existing):
            projected.metadata.uid = existing.metadata.uid
            projected.metadata.resource_version = existing.metadata.resource_version
            if hasattr(existing, "status"):
                projected.status = existing.status  # status is super-owned
            api.update(projected)
            self.metrics.inc_downward()
            m = self._meter
            if m is not None:
                m.add_many(tenant, (("down_items", 1.0),
                                    ("down_bytes",
                                     float(obj_nbytes(projected)))))
            self._trace_down(tenant_obj, t0, tenant, kind, ns, name)

    def _trace_down(self, tenant_obj: Any, t0: float, tenant: str, kind: str,
                    ns: str, name: str, batch: int = 0) -> None:
        """Record a "syncer.down" child span for an object that carries a
        traceparent annotation (dequeue -> super-cluster write landed)."""
        tr = self.tracer
        if tr is None:
            return
        tp = tenant_obj.metadata.annotations.get(TRACEPARENT_KEY)
        if not tp or not sampled_carrier(tp):
            return                  # unsampled: child can't be retained
        attrs: Dict[str, Any] = {"kind": kind, "ns": ns, "name": name}
        if batch:
            attrs["batch"] = batch
        tr.record_from(tp, "syncer.down", t0, time.monotonic(),
                       tenant=tenant, attrs=attrs)

    def _reconcile_down_fast(self, tenant: str, keys: List[DownItem],
                             api: Optional[Any] = None
                             ) -> Tuple[List[DownItem], List[DownItem]]:
        """Coalesced downward pass over a same-tenant burst — full CRUD.

        State comparisons run against the super-side informer caches (paper
        §III-C); missing objects, stale specs, and tenant-side deletions are
        then committed with ONE batched super-cluster write EACH
        (``create_batch`` / ``update_batch`` / ``delete_batch``, all a single
        store lock round). Returns ``(done, slow)``: ``slow`` items —
        Namespace objects, cache races (create conflict / stale update rv),
        and unconfirmed absences — need the authoritative per-item reconcile.
        The periodic scan remediates any rare staleness this cache-based path
        lets through, exactly as it does for every other informer-cache
        comparison.
        """
        api = api or self.super_api
        tr = self.tracer
        t0 = time.monotonic() if tr is not None else 0.0
        traced: Dict[DownItem, Any] = {}
        fast: List[DownItem] = []
        slow: List[DownItem] = []
        with self._tenants_lock:
            reg = self.tenants.get(tenant)
        if reg is None:
            return list(keys), slow
        to_create: List[Any] = []
        create_keys: List[DownItem] = []
        to_update: List[Any] = []
        update_keys: List[DownItem] = []
        to_delete: List[Tuple[str, str, str]] = []   # (kind, super_ns, name)
        delete_keys: List[DownItem] = []
        for key in keys:
            kind, ns, name = key
            sup_inf = self._super_informers.get(kind)
            tenant_inf = reg.informers.get(kind)
            if (kind == "Namespace" or sup_inf is None or tenant_inf is None
                    or not tenant_inf.wait_for_cache_sync(0)):
                slow.append(key)     # authoritative per-item path (which
                continue             # retries mid-registration informers)
            tenant_obj = tenant_inf.cache.get(ns, name)
            super_ns = self._translate_ns(reg, ns)
            cached = sup_inf.cache.get(super_ns, name)
            if tenant_obj is None:          # deleted in tenant
                if cached is None:
                    # absence not confirmed by the cache (it may simply lag
                    # the create): authoritative per-item check
                    slow.append(key)
                else:
                    to_delete.append((kind, super_ns, name))
                    delete_keys.append(key)
                continue
            if cached is None:
                self._ensure_super_namespace(reg, super_ns, tenant, ns,
                                             api=api)
                to_create.append(
                    self._project_down(tenant_obj, tenant, ns, super_ns))
                create_keys.append(key)
                if tr is not None:
                    tp = tenant_obj.metadata.annotations.get(TRACEPARENT_KEY)
                    if tp and sampled_carrier(tp):
                        traced[key] = tenant_obj
            elif _spec_equal(tenant_obj, cached):
                fast.append(key)            # echo: two-side states match
            else:                           # spec update: batched write
                proj = self._project_down(tenant_obj, tenant, ns, super_ns)
                proj.metadata.uid = cached.metadata.uid
                proj.metadata.resource_version = cached.metadata.resource_version
                if hasattr(cached, "status"):
                    proj.status = deepcopy_obj(cached.status)  # super-owned
                to_update.append(proj)
                update_keys.append(key)
                if tr is not None:
                    tp = tenant_obj.metadata.annotations.get(TRACEPARENT_KEY)
                    if tp and sampled_carrier(tp):
                        traced[key] = tenant_obj
        m = self._meter

        def route_write(keys_projs: List[Tuple[DownItem, Any]],
                        applied: int, conflicted: List[Any]) -> None:
            # cache races (create conflict / stale update rv) go slow for
            # the authoritative per-item retry; the rest are done
            self.metrics.inc_downward(applied)
            lost = {(obj_kind(o), o.metadata.namespace, o.metadata.name)
                    for o in conflicted}
            nbytes = 0
            for key, proj in keys_projs:
                if (key[0], proj.metadata.namespace, key[2]) in lost:
                    slow.append(key)
                else:
                    fast.append(key)
                    nbytes += obj_nbytes(proj)
                    tobj = traced.pop(key, None)
                    if tobj is not None:
                        self._trace_down(tobj, t0, tenant, key[0], key[1],
                                         key[2], batch=len(keys))
            if m is not None and applied:
                # one meter round for the whole batched write: items land
                # under the burst's tenant with the batch's byte volume
                m.add_many(tenant, (("down_items", float(applied)),
                                    ("down_bytes", float(nbytes))))

        if to_create:
            created, conflicted = api.create_batch(to_create)
            route_write(list(zip(create_keys, to_create)),
                        len(created), conflicted)
        if to_update:
            updated, conflicted = api.update_batch(to_update)
            route_write(list(zip(update_keys, to_update)),
                        len(updated), conflicted)
        if to_delete:
            deleted, _missing = api.delete_batch(to_delete)
            self.metrics.inc_downward(len(deleted))
            if m is not None and deleted:
                m.add(tenant, "down_items", float(len(deleted)))
            gone = {(obj_kind(o), o.metadata.namespace, o.metadata.name)
                    for o in deleted}
            for skey, key in zip(to_delete, delete_keys):
                if skey in gone and key[0] == "WorkUnit":
                    self.vnodes.unbind(reg.plane, key[1], key[2])
                fast.append(key)            # missing == already gone: done
        return fast, slow

    # ------------------------------------------------------------ periodic scan

    def scan_once(self) -> int:
        """Re-enqueue every object whose two-side states mismatch.

        Paper §III-C: "the syncer will periodically scan the synchronized
        objects and remediate any state mismatch by resending the object to
        the worker queue again."
        """
        t0 = time.monotonic()
        fixes = 0
        with self._tenants_lock:
            regs = list(self.tenants.items())
        for kind in SYNCED_KINDS_DOWNWARD:
            if kind == "Namespace":
                continue
            # ONE super-cluster list per kind per scan (was per tenant,
            # making the orphan pass O(tenants x super-objects)); paged +
            # zero-copy: the scan only COMPARES, so shared refs suffice and
            # a 100k-object kind is never deepcopied nor held under lock
            super_by_key: Dict[Tuple[str, str], Any] = {}
            orphans_by_tenant: Dict[str, List[Tuple[Any, str]]] = {}
            sobjs, _rv = self.super_api.list_all_pages(kind, copy=False)
            for sobj in sobjs:
                sns = sobj.metadata.namespace
                super_by_key[(sns, sobj.metadata.name)] = sobj
                resolved = self._resolve_super_ns(sns)
                if resolved is not None:
                    orphans_by_tenant.setdefault(resolved[0], []).append(
                        (sobj, resolved[1]))
            for tenant, reg in regs:
                tenant_inf = reg.informers.get(kind)
                if tenant_inf is None or not tenant_inf.wait_for_cache_sync(0):
                    # registration in flight or cache not yet synced: an
                    # empty pre-sync cache would read as "everything
                    # deleted" and orphan-enqueue the tenant's live super
                    # objects; the next scan covers this tenant instead
                    continue
                tcache = tenant_inf.cache
                seen_super = set()
                for tobj in tcache.list():
                    ns, name = tobj.metadata.namespace, tobj.metadata.name
                    super_ns = self._translate_ns(reg, ns)
                    sobj = super_by_key.get((super_ns, name))
                    if sobj is None or not _spec_equal(
                            self._project_down(tobj, tenant, ns, super_ns), sobj):
                        reg.shard.queue.add(tenant, (kind, ns, name))
                        fixes += 1
                    elif (kind in SYNCED_KINDS_UPWARD and hasattr(tobj, "status")
                          and not _status_equal(tobj.status, sobj.status,
                                                ignore_node=True)):
                        self.upward.enqueue(kind, super_ns, name)
                        fixes += 1
                    seen_super.add((super_ns, name))
                # orphans in super (tenant object gone but super copy remains)
                for sobj, tenant_ns in orphans_by_tenant.get(tenant, []):
                    if (sobj.metadata.namespace,
                            sobj.metadata.name) not in seen_super:
                        reg.shard.queue.add(
                            tenant, (kind, tenant_ns, sobj.metadata.name))
                        fixes += 1
        self._expire_events()
        self.metrics.inc_scan(fixes, time.monotonic() - t0)
        return fixes

    def _expire_events(self) -> int:
        """k8s-style event TTL: drop Events (super AND tenant copies) whose
        last_timestamp is older than ``event_ttl``. Without this, a tenant
        churning uniquely-named WorkUnits would accumulate one Started/Ready
        Event pair per unit forever — deletion of the involved object never
        removes its events, exactly as in Kubernetes, where the TTL is the
        bound."""
        if self.event_ttl <= 0:
            return 0
        cutoff = time.time() - self.event_ttl
        with self._tenants_lock:
            apis = [reg.plane.api for reg in self.tenants.values()]
        expired = 0
        for api in [self.super_api] + apis:
            events, _rv = api.list_all_pages("Event", copy=False)
            stale = [("Event", e.metadata.namespace, e.metadata.name)
                     for e in events
                     if e.last_timestamp < cutoff]
            if stale:
                deleted, _missing = api.delete_batch(stale)
                expired += len(deleted)
        if expired:
            self.metrics.inc_events_expired(expired)
        return expired

    # ----------------------------------------------------------------- helpers

    def _translate_ns(self, reg: TenantRegistration, tenant_ns: str) -> str:
        super_ns = f"{reg.prefix}-{tenant_ns}"
        with self._ns_lock:
            self._ns_map[super_ns] = (reg.plane.name, tenant_ns)
        return super_ns

    def _resolve_super_ns(self, super_ns: str) -> Optional[Tuple[str, str]]:
        with self._ns_lock:
            hit = self._ns_map.get(super_ns)
        if hit is not None:
            return hit
        with self._tenants_lock:
            regs = list(self.tenants.values())
        for reg in regs:
            p = reg.prefix + "-"
            if super_ns.startswith(p):
                out = (reg.plane.name, super_ns[len(p):])
                with self._ns_lock:
                    self._ns_map[super_ns] = out
                return out
        return None

    def _ensure_super_namespace(self, reg: TenantRegistration, super_ns: str,
                                tenant: str, tenant_ns: str,
                                api: Optional[Any] = None) -> None:
        api = api or self.super_api
        with reg.ensured_lock:
            if super_ns in reg.ensured_ns:
                return
        try:
            api.get("Namespace", "", super_ns)
        except NotFoundError:
            nsobj = Namespace()
            nsobj.metadata.name = super_ns
            nsobj.metadata.annotations["vc/tenant"] = tenant
            nsobj.metadata.annotations["vc/namespace"] = tenant_ns
            try:
                api.create(nsobj)
            except AlreadyExistsError:
                pass
        with reg.ensured_lock:
            reg.ensured_ns.add(super_ns)

    def _project_down(self, tenant_obj: Any, tenant: str, tenant_ns: str,
                      super_ns: str) -> Any:
        proj = deepcopy_obj(tenant_obj)
        proj.metadata.namespace = super_ns
        proj.metadata.uid = ""
        proj.metadata.resource_version = 0
        proj.metadata.annotations["vc/tenant"] = tenant
        proj.metadata.annotations["vc/namespace"] = tenant_ns
        if hasattr(proj, "status"):
            proj.status = type(proj.status)()
        return proj

    def _delete_super(self, kind: str, ns: str, name: str,
                      api: Optional[Any] = None) -> None:
        try:
            (api or self.super_api).delete(kind, ns, name)
        except NotFoundError:
            pass

    # -------------------------------------------------------------- accounting

    def registry_snapshot(self) -> Dict[str, Any]:
        """Runtime MetricsRegistry snapshot for the syncer's controllers."""
        return self.up_controller.metrics.snapshot()

    def memory_estimate(self) -> int:
        total = 0
        with self._tenants_lock:
            regs = list(self.tenants.values())
        for reg in regs:
            for inf in reg.informers.values():
                total += inf.cache.nbytes_estimate()
        for inf in self._super_informers.values():
            total += inf.cache.nbytes_estimate()
        return total


# the comparison helpers now live in objects.py (the upward pipeline needs
# them too); internal aliases keep this module's call sites unchanged
_spec_equal = spec_equal
_status_equal = status_equal
