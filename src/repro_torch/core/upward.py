"""Upward status/event pipeline: sharded, coalescing, batched (paper §IV).

The paper's syncer is bidirectional; upward synchronization (super-cluster
status -> tenant control planes) is the half tenants actually *watch* — a
tenant polls its own apiserver for WorkUnit phases, Service endpoints, and
Events, so upward latency is directly tenant-visible (the Fig.8 breakdown
carries the UWS queue as a first-class phase). This module mirrors the
downward path's architecture on the upward axis:

- **Events** (:class:`EventRecorder`): node agents record Kubernetes-style
  :class:`~repro_torch.core.objects.Event` objects on WorkUnit phase transitions
  and node heartbeats. Repeats of the same (involved, reason, component)
  tuple compress into one object (``count`` increments, ``last_timestamp``
  advances) — kubelet event-aggregation semantics. Events are synced upward
  so tenants can "kubectl get events" inside their own control planes.
- **Upward shards** (:class:`UpwardShard`): the shared upward FIFO is
  replaced by tenant-hash shards on a consistent-hash
  :class:`~repro_torch.core.ring.ShardRing` — each shard owns a per-tenant
  :class:`~repro_torch.core.fairqueue.FairWorkQueue` (WRR dispatch, Fig.11
  fairness on the upward axis too) and its own super-API client, and runs
  its workers on the shared cooperative executor.
- **Latest-wins coalescing + batched writes** (:meth:`UpwardPipeline.
  reconcile_fast`): a key is queued at most once (fair-queue dedup), and
  reconcile reads the *current* super informer cache — N rapid status flaps
  collapse into one write of the latest state. Same-tenant bursts drain as
  one batch and commit with ONE ``update_status_batch`` per tenant plane
  (``ObjectStore.update_status_many``: a single lock round), with Events
  created/bumped the same way.
- **Elasticity** (:meth:`UpwardPipeline.resize_locked`, driven by
  ``Syncer.resize_upward_shards``): the autoscaler's third actuator grows
  and shrinks the upward fleet from upward queue depth and sync latency,
  live-migrating only ~1/N tenants per step — exactly like the downward
  fleet.
"""
from __future__ import annotations

import hashlib
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from .fairqueue import FairWorkQueue
from .objects import Event, deepcopy_obj, status_equal
from .ring import ShardRing
from .runtime import Controller, RetryLater
from .store import AlreadyExistsError, ConflictError, NotFoundError
from .trace import TRACEPARENT_KEY, sampled_carrier

UpKey = Tuple[str, str, str]           # (kind, super_ns, name)


def event_name(involved_kind: str, involved_name: str, reason: str,
               component: str) -> str:
    """Deterministic dedup name: repeats of one (involved, reason, source)
    tuple always address the same Event object."""
    h = hashlib.sha256(
        f"{involved_kind}/{involved_name}/{reason}/{component}"
        .encode()).hexdigest()[:10]
    return f"{involved_name}.{h}"


class EventRecorder:
    """Records deduplicated Events against one apiserver (kubelet analogue).

    ``record`` is a read-modify-write: an existing Event for the same
    (involved object, reason, component) gets ``count += 1`` and a fresh
    ``last_timestamp`` (compression); a first occurrence creates the object.
    Safe under concurrent recorders — a create race falls back to the bump.
    """

    def __init__(self, api: Any, component: str, host: str = ""):
        self.api = api
        self.component = component
        self.host = host
        self.recorded = 0

    def record(self, involved_kind: str, namespace: str, involved_name: str,
               reason: str, message: str = "", type: str = "Normal") -> Any:
        name = event_name(involved_kind, involved_name, reason,
                          self.component)
        now = time.time()

        def bump(e: Event) -> None:
            e.count += 1
            e.last_timestamp = now
            e.message = message
            e.type = type

        self.recorded += 1
        try:
            return self.api.update_status("Event", namespace, name, bump)
        except NotFoundError:
            pass
        ev = Event()
        ev.metadata.name = name
        ev.metadata.namespace = namespace
        ev.involved_kind = involved_kind
        ev.involved_namespace = namespace
        ev.involved_name = involved_name
        ev.reason = reason
        ev.message = message
        ev.type = type
        ev.source_component = self.component
        ev.source_host = self.host
        ev.count = 1
        ev.first_timestamp = ev.last_timestamp = now
        try:
            return self.api.create(ev)
        except AlreadyExistsError:   # lost the create race: bump instead
            return self.api.update_status("Event", namespace, name, bump)


class UpwardShard(Controller):
    """One upward shard: a per-shard fair queue + workers serving the
    tenants hashed onto it, with its OWN super-API client (dedicated token
    bucket) for the reads the status projection needs.

    Items are ``(tenant, (kind, super_ns, name))``. A key that flaps while
    queued is deduplicated by the fair queue and reconciled once from the
    *latest* informer-cache state — the per-object latest-wins coalescing.
    """

    def __init__(self, syncer: Any, shard_id: int, *, workers: int,
                 fair: bool, batch_size: int):
        super().__init__(f"syncer-uws-{shard_id}",
                         queue=FairWorkQueue(f"upward-{shard_id}", fair=fair),
                         workers=workers, batch_size=batch_size,
                         retry_on=(ConflictError, RetryLater), drop_on=())
        self.syncer = syncer
        self.shard_id = shard_id
        self.api = syncer.super_api.client(f"uws-{shard_id}")
        # shards created after wiring (resize) inherit the live meter
        self.queue.meter = syncer._meter

    def _retry_queue(self, item: Any) -> Any:
        """Retries re-enter the tenant's CURRENT upward shard (a resize may
        have migrated the tenant while the item was in flight)."""
        reg = self.syncer.tenants.get(item[0])   # GIL-atomic dict read
        return reg.upward_shard.queue if reg is not None else self.queue

    def _stamp_dequeue(self, kind: str, super_ns: str, name: str,
                       now: Optional[float] = None) -> Optional[Any]:
        if kind != "WorkUnit":
            return None
        sy = self.syncer
        resolved = sy._resolve_super_ns(super_ns)
        if resolved is None:
            return None
        tl = sy.metrics.timeline(resolved[0], resolved[1], name)
        if tl.uws_dequeue == 0.0 and tl.super_ready > 0.0:
            tl.uws_dequeue = now if now is not None else time.time()
        return tl

    def reconcile(self, item: Any) -> None:
        tenant, (kind, super_ns, name) = item
        tl = self._stamp_dequeue(kind, super_ns, name)
        self.syncer.upward.reconcile_one(tenant, kind, super_ns, name,
                                         api=self.api)
        # stamped AFTER a successful sync only: a raise above means the item
        # will be retried, and stamping now would undercount the real
        # UWS-Process phase in the fig7/fig8 latency breakdowns
        if tl is not None and tl.uws_done == 0.0 and tl.super_ready > 0.0:
            tl.uws_done = time.time()

    def reconcile_batch(self, items: List[Any]) -> None:
        """Coalesce a same-tenant burst: latest-wins status computation off
        the informer caches plus ONE batched tenant-plane write; leftovers
        (unknown kinds, create races) take the authoritative per-item path."""
        if len(items) == 1:
            return self._reconcile_one(items[0])
        tenant = items[0][0]
        now = time.time()
        tls = {}
        for _, (kind, super_ns, name) in items:
            tl = self._stamp_dequeue(kind, super_ns, name, now)
            if tl is not None:
                tls[(kind, super_ns, name)] = tl
        t0 = time.monotonic()
        try:
            fast, slow = self.syncer.upward.reconcile_fast(
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
            tl = tls.get(key)
            if tl is not None and tl.uws_done == 0.0 and tl.super_ready > 0.0:
                tl.uws_done = done
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


class UpwardPipeline:
    """The upward fleet: shard controllers + ring + reconcile logic.

    Owned by :class:`~repro_torch.core.syncer.Syncer` (which provides the tenant
    registry, namespace resolution, vNode manager, and super informers);
    this class owns everything upward-specific so the axis can be reasoned
    about, resized, and benchmarked on its own.
    """

    def __init__(self, syncer: Any, *, shards: int, total_workers: int,
                 fair: bool, batch_size: int, ring_vnodes: int = 64):
        self.syncer = syncer
        self.num_shards = max(1, int(shards))
        self.fair = fair
        self.batch_size = max(1, int(batch_size))
        self.ring_vnodes = max(1, int(ring_vnodes))
        self.ring = ShardRing(self.num_shards, self.ring_vnodes)
        per_shard = max(1, int(total_workers) // self.num_shards)
        self.controllers: List[UpwardShard] = [
            UpwardShard(syncer, i, workers=per_shard, fair=fair,
                        batch_size=self.batch_size)
            for i in range(self.num_shards)]

    # ------------------------------------------------------------- routing

    def shard_for_uid(self, uid: str) -> UpwardShard:
        return self.controllers[self.ring.shard_for(uid)]

    def enqueue(self, kind: str, super_ns: str, name: str) -> bool:
        """Route one super-side key onto its tenant's current upward shard.
        Unresolvable namespaces (cluster-scoped events, foreign objects) are
        skipped. Mirrors the downward handlers' migration re-check: if a
        resize races the add, re-add on the new shard (dedup makes the
        double add harmless)."""
        sy = self.syncer
        resolved = sy._resolve_super_ns(super_ns)
        if resolved is None:
            return False
        tenant = resolved[0]
        while True:
            reg = sy.tenants.get(tenant)     # GIL-atomic dict read
            if reg is None:
                return False
            shard = reg.upward_shard
            shard.queue.add(tenant, (kind, super_ns, name))
            if reg.upward_shard is shard:
                return True

    def coalesced_total(self) -> int:
        """Keys absorbed by queue dedup (flaps that never cost a write)."""
        return sum(c.queue.deduped for c in self.controllers)

    # ------------------------------------------------------------ resizing

    def resize_locked(self, n: int) -> Dict[str, int]:
        """Resize the upward fleet; caller holds the syncer's resize lock.
        Mirrors the downward resize minus informer handover (super informers
        are shared, attached to shard 0, and shard 0 never retires)."""
        sy = self.syncer
        if n == self.num_shards:
            return {}
        registry = self.controllers[0].metrics
        running = any(c.running for c in self.controllers)
        per_shard = self.controllers[0].workers
        while len(self.controllers) < n:
            i = len(self.controllers)
            c = UpwardShard(sy, i, workers=per_shard, fair=self.fair,
                            batch_size=self.batch_size)
            c.metrics = registry
            c.executor = sy.executor
            self.controllers.append(c)
            sy.controllers.append(c)
            if running:
                c.start()   # must run before tenants route onto it
            if sy.manager is not None:
                sy.manager.add(c)
        new_ring = ShardRing(n, self.ring_vnodes)
        with sy._tenants_lock:
            regs = list(sy.tenants.values())
        moved: Dict[str, int] = {}
        for reg in regs:
            target = new_ring.shard_for(reg.uid)
            if target == reg.upward_shard.shard_id:
                continue
            self._migrate_tenant(reg, self.controllers[target])
            moved[reg.plane.name] = target
        self.ring = new_ring
        self.num_shards = n
        if len(self.controllers) > n:       # shrink: now-empty tail shards
            for c in self.controllers[n:]:
                c.stop()
                sy.controllers.remove(c)
                if sy.manager is not None:
                    sy.manager.remove(c)
            del self.controllers[n:]
        return moved

    def _migrate_tenant(self, reg: Any, new_shard: UpwardShard) -> None:
        tenant = reg.plane.name
        old_shard = reg.upward_shard
        new_shard.queue.register_tenant(tenant, reg.plane.weight)
        reg.upward_shard = new_shard    # enqueue() resolves via reg
        pending = old_shard.queue.drain_tenant(tenant)
        old_shard.queue.unregister_tenant(tenant)
        for key in pending:
            new_shard.queue.add(tenant, key)
        # clear any ghost re-registration from a racing enqueue (see the
        # downward migration's identical second pass)
        old_shard.queue.drain_tenant(tenant)
        old_shard.queue.unregister_tenant(tenant)

    # --------------------------------------------------------- reconcilers

    def reconcile_one(self, tenant: str, kind: str, super_ns: str, name: str,
                      api: Optional[Any] = None) -> None:
        """Authoritative per-item upward sync (also the slow path under
        coalescing): super status/event is the source of truth -> project
        back into the tenant plane."""
        sy = self.syncer
        resolved = sy._resolve_super_ns(super_ns)
        if resolved is None:
            return
        tenant_ns = resolved[1]
        with sy._tenants_lock:
            reg = sy.tenants.get(tenant)
        if reg is None:
            return
        inf = sy._super_informers.get(kind)
        super_obj = inf.cache.get(super_ns, name) if inf is not None else None
        if super_obj is None:
            return  # deletion downward is handled by the downward reconciler
        if kind == "WorkUnit":
            self._sync_unit_status_up(reg, tenant_ns, name, super_obj,
                                      api=api)
        elif kind == "Service":
            self._sync_service_up(reg, tenant_ns, name, super_obj)
        elif kind == "Event":
            self._sync_event_up(reg, tenant_ns, name, super_obj)
        sy.metrics.inc_upward()
        m = sy._meter
        if m is not None:
            m.add(tenant, "up_items", 1.0)

    def reconcile_fast(self, tenant: str, keys: List[UpKey],
                       api: Optional[Any] = None
                       ) -> Tuple[List[UpKey], List[UpKey]]:
        """Coalesced upward pass over a same-tenant burst.

        Latest states are read from the super informer caches; unchanged
        objects are skipped (echo suppression), and the rest are committed
        with ONE ``update_status_batch`` per tenant plane — plus one
        ``update_status_batch`` + ``create_batch`` round for Events.
        Returns ``(fast, slow)``: ``slow`` keys (unknown kinds, event create
        races) need the authoritative per-item reconcile.
        """
        sy = self.syncer
        tr = sy.tracer
        t0 = time.monotonic() if tr is not None else 0.0
        traced: List[Tuple[UpKey, Any, str]] = []
        fast: List[UpKey] = []
        slow: List[UpKey] = []
        with sy._tenants_lock:
            reg = sy.tenants.get(tenant)
        if reg is None:
            return list(keys), slow
        status_updates: List[Tuple[str, str, str, Callable]] = []
        status_keys: List[UpKey] = []
        ev_updates: List[Tuple[str, str, str, Callable]] = []
        ev_sources: List[Tuple[UpKey, Any, str]] = []
        synced = 0
        # same-tenant batches share a namespace almost always: memoize the
        # reverse-map hit so a batch costs one resolve, not one per key
        ns_memo: Dict[str, Any] = {}
        for key in keys:
            kind, super_ns, name = key
            resolved = ns_memo.get(super_ns)
            if resolved is None:
                resolved = sy._resolve_super_ns(super_ns)
                ns_memo[super_ns] = resolved if resolved is not None else False
            if resolved is False or resolved is None:
                fast.append(key)        # tenant gone: nothing to project
                continue
            tenant_ns = resolved[1]
            inf = sy._super_informers.get(kind)
            sobj = inf.cache.get(super_ns, name) if inf is not None else None
            if sobj is None:
                fast.append(key)        # deleted upstream: downward cleans up
                continue
            if kind == "WorkUnit":
                status = self._project_unit_status(reg, tenant_ns, name,
                                                   sobj, api=api)
                winf = reg.informers.get("WorkUnit")
                cached = (winf.cache.get(tenant_ns, name)
                          if winf is not None else None)
                if cached is not None and status_equal(cached.status, status):
                    fast.append(key)    # echo: tenant already shows it
                    continue

                def mutate(u: Any, status: Any = status) -> None:
                    u.status = status
                status_updates.append(("WorkUnit", tenant_ns, name, mutate))
                status_keys.append(key)
                if tr is not None:
                    tp = sobj.metadata.annotations.get(TRACEPARENT_KEY)
                    if tp and sampled_carrier(tp):
                        traced.append((key, sobj, tenant_ns))
            elif kind == "Service":
                eps, vip = list(sobj.endpoints), sobj.virtual_ip
                sinf = reg.informers.get("Service")
                cached = (sinf.cache.get(tenant_ns, name)
                          if sinf is not None else None)
                if (cached is not None and cached.endpoints == eps
                        and cached.virtual_ip == vip):
                    fast.append(key)
                    continue

                def mutate(s: Any, eps: Any = eps, vip: str = vip) -> None:
                    s.endpoints = eps
                    s.virtual_ip = vip
                status_updates.append(("Service", tenant_ns, name, mutate))
                status_keys.append(key)
                if tr is not None:
                    tp = sobj.metadata.annotations.get(TRACEPARENT_KEY)
                    if tp and sampled_carrier(tp):
                        traced.append((key, sobj, tenant_ns))
            elif kind == "Event":
                ev_updates.append(("Event", tenant_ns, name,
                                   _event_bump(sobj)))
                ev_sources.append((key, sobj, tenant_ns))
            else:
                slow.append(key)
        if status_updates:
            updated, missing = reg.plane.api.update_status_batch(
                status_updates)
            # missing == tenant deleted it mid-flight: same as the per-item
            # path's NotFound pass — the downward reconciler cleans up
            fast.extend(status_keys)
            synced += len(updated)
            if traced:
                miss = set(missing)
                for key, sobj, t_ns in traced:
                    if (key[0], t_ns, key[2]) not in miss:
                        self._trace_up(sobj, t0, tenant, key[0], t_ns,
                                       key[2], batch=len(keys))
        if ev_updates:
            updated, missing = reg.plane.api.update_status_batch(ev_updates)
            synced += len(updated)
            miss = set(missing)
            creates: List[Event] = []
            create_keys: List[UpKey] = []
            for key, sobj, tenant_ns in ev_sources:
                if ("Event", tenant_ns, key[2]) in miss:
                    creates.append(self._project_event(sobj, tenant_ns))
                    create_keys.append(key)
                else:
                    fast.append(key)
            if creates:
                created, conflicted = reg.plane.api.create_batch(creates)
                synced += len(created)
                lost = {(o.metadata.namespace, o.metadata.name)
                        for o in conflicted}
                for key, obj in zip(create_keys, creates):
                    if (obj.metadata.namespace, obj.metadata.name) in lost:
                        slow.append(key)    # create race: per-item retry
                    else:
                        fast.append(key)
        if synced:
            sy.metrics.inc_upward(synced)
            m = sy._meter
            if m is not None:
                # the whole coalesced burst attributes to its (single)
                # tenant: N landed commits -> N up_items, exactly
                m.add(tenant, "up_items", float(synced))
        return fast, slow

    # -------------------------------------------------------------- tracing

    def _trace_up(self, sobj: Any, t0: float, tenant: str, kind: str,
                  tenant_ns: str, name: str, batch: int = 0) -> None:
        """Record a "syncer.up" child span for a traced object whose status
        just landed in the tenant plane, and — since a landed status IS the
        end of the paper's propagation path — close the pending end-to-end
        span, feeding its duration to the propagation histogram and the
        per-tenant SLO tracker. Echo-suppressed keys never reach here, so
        the e2e span closes on the FIRST real status return only."""
        sy = self.syncer
        tr = sy.tracer
        if tr is None:
            return
        tp = sobj.metadata.annotations.get(TRACEPARENT_KEY)
        if not tp:
            return
        if not sampled_carrier(tp):
            # head-unsampled: nothing was registered at the root, no child
            # can be retained, and the SLO/histogram feeds run on the
            # sampled subset — the unsampled path pays zero tracer calls
            return
        end = time.monotonic()
        attrs: Dict[str, Any] = {"kind": kind, "ns": tenant_ns, "name": name}
        if batch:
            attrs["batch"] = batch
        tr.record_from(tp, "syncer.up", t0, end, tenant=tenant, attrs=attrs)
        root = tr.finish_pending(tp, end)
        if root is None:
            return      # already closed (or never opened here)
        dur = max(0.0, root.end - root.start)
        m = self.controllers[0].metrics
        m.histogram("propagation_seconds").observe(dur)
        m.histogram("propagation_seconds", tenant=tenant).observe(dur)
        if sy.slo is not None:
            sy.slo.observe("propagation", tenant, dur)

    # ------------------------------------------------------ kind projectors

    def _project_unit_status(self, reg: Any, tenant_ns: str, name: str,
                             super_obj: Any,
                             api: Optional[Any] = None) -> Any:
        """Super WorkUnit status with the physical node mapped to a vNode."""
        sy = self.syncer
        vnode_name = ""
        if super_obj.status.node:
            node_inf = sy._super_informers.get("Node")
            pnode = None
            if node_inf is not None:
                pnode = node_inf.cache.get("", super_obj.status.node)
            if pnode is None:
                try:
                    pnode = (api or sy.super_api).get(
                        "Node", "", super_obj.status.node)
                except NotFoundError:
                    pnode = None
            if pnode is not None:
                vnode_name = sy.vnodes.bind(reg.plane, pnode, tenant_ns, name)
        status = deepcopy_obj(super_obj.status)
        if vnode_name:
            status.node = vnode_name
        return status

    def _sync_unit_status_up(self, reg: Any, tenant_ns: str, name: str,
                             super_obj: Any,
                             api: Optional[Any] = None) -> None:
        t0 = time.monotonic() if self.syncer.tracer is not None else 0.0
        status = self._project_unit_status(reg, tenant_ns, name, super_obj,
                                           api=api)
        winf = reg.informers.get("WorkUnit")
        cached = winf.cache.get(tenant_ns, name) if winf is not None else None
        if cached is not None and status_equal(cached.status, status):
            return

        def mutate(u: Any) -> None:
            u.status = status

        try:
            reg.plane.api.update_status("WorkUnit", tenant_ns, name, mutate)
        except NotFoundError:
            pass  # tenant deleted it mid-flight; scan/downward will clean up
        else:
            self._trace_up(super_obj, t0, reg.plane.name, "WorkUnit",
                           tenant_ns, name)

    def _sync_service_up(self, reg: Any, tenant_ns: str, name: str,
                         super_obj: Any) -> None:
        t0 = time.monotonic() if self.syncer.tracer is not None else 0.0
        eps = list(super_obj.endpoints)
        vip = super_obj.virtual_ip
        sinf = reg.informers.get("Service")
        cached = sinf.cache.get(tenant_ns, name) if sinf is not None else None
        if (cached is not None and cached.endpoints == eps
                and cached.virtual_ip == vip):
            return

        def mutate(s: Any) -> None:
            s.endpoints = eps
            s.virtual_ip = vip

        try:
            reg.plane.api.update_status("Service", tenant_ns, name, mutate)
        except NotFoundError:
            pass
        else:
            self._trace_up(super_obj, t0, reg.plane.name, "Service",
                           tenant_ns, name)

    def _sync_event_up(self, reg: Any, tenant_ns: str, name: str,
                       super_obj: Any) -> None:
        """Project one super Event into the tenant plane (latest-wins:
        count/lastTimestamp compression carries over verbatim)."""
        try:
            reg.plane.api.update_status("Event", tenant_ns, name,
                                        _event_bump(super_obj))
            return
        except NotFoundError:
            pass
        ev = self._project_event(super_obj, tenant_ns)
        try:
            reg.plane.api.create(ev)
        except AlreadyExistsError:
            reg.plane.api.update_status("Event", tenant_ns, name,
                                        _event_bump(super_obj))

    @staticmethod
    def _project_event(super_obj: Any, tenant_ns: str) -> Event:
        ev = deepcopy_obj(super_obj)
        ev.metadata.namespace = tenant_ns
        ev.metadata.uid = ""
        ev.metadata.resource_version = 0
        ev.metadata.creation_timestamp = 0.0
        ev.involved_namespace = tenant_ns
        return ev


def _event_bump(super_obj: Any) -> Callable[[Event], None]:
    """Mutator copying the super event's compressed counters onto the
    tenant copy (latest wins — never an increment, so replays are safe)."""
    count = super_obj.count
    last = super_obj.last_timestamp
    message = super_obj.message
    type_ = super_obj.type

    def mutate(e: Event) -> None:
        e.count = count
        e.last_timestamp = last
        e.message = message
        e.type = type_
    return mutate
