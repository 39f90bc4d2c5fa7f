"""Control→data plane bridge: engine replicas hosted as WorkUnits.

:class:`ServingFleet` is a controller on the shared runtime that makes
tenant inference run *under* the control plane instead of beside it:

- it declares the desired replica count as ``engine-<i>`` WorkUnits in a
  reserved super-cluster namespace; the SuperScheduler places them on
  nodes like any workload;
- each NodeAgent's provider is wrapped in an :class:`EngineProvider`:
  when a unit with the ``engine-replica`` payload role reaches ``run``,
  the provider asks the fleet to spawn a live :class:`EngineReplica` —
  a :class:`~repro_torch.serving.engine.GenerationEngine` plus ONE dedicated
  OS drive thread (decode compute must not ride the cooperative
  executor: a fused step would hog a quantum);
- serving requests enter through :meth:`ServingFleet.submit` for tenants
  registered from their control planes, flow through the shared
  per-tenant WRR :class:`~repro_torch.serving.scheduler.SlotScheduler`, and
  per-tenant TTFT / tokens-per-second land in the ``MetricsRegistry`` —
  the signals the autoscaler's fourth (engine-replica) actuator reads to
  drive :meth:`ServingFleet.resize`.

Scale-down drains: a retiring replica admits nothing new but finishes
its in-flight slots before its thread exits, so no accepted request is
dropped by an autoscaler shrink.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ..core.agent import NodeAgent, Provider
from ..core.apiserver import APIServer, TenantControlPlane
from ..core.objects import WorkUnit
from ..core.runtime import Controller
from ..core.store import ADDED, AlreadyExistsError, DELETED, MODIFIED, \
    NotFoundError
from ..core.workqueue import WorkQueue

from .engine import GenerationEngine, Request
from .scheduler import SlotScheduler

import numpy as np

SERVING_NS = "vc-serving"
ENGINE_ROLE = "engine-replica"


class EngineProvider(Provider):
    """Provider wrapper installed on every node agent: units carrying the
    ``engine-replica`` payload role become live engine replicas; everything
    else is delegated to the node's original provider."""

    def __init__(self, fleet: "ServingFleet", node_name: str,
                 inner: Provider):
        self.fleet = fleet
        self.node_name = node_name
        self.inner = inner

    @staticmethod
    def _is_engine(unit: WorkUnit) -> bool:
        return unit.spec.payload.get("role") == ENGINE_ROLE

    def run(self, unit: WorkUnit) -> None:
        if self._is_engine(unit):
            self.fleet.spawn_replica(unit.metadata.key, self.node_name)
        else:
            self.inner.run(unit)

    def wait_ready(self, unit: WorkUnit) -> None:
        if not self._is_engine(unit):
            self.inner.wait_ready(unit)

    def logs(self, unit_key: str) -> str:
        rep = self.fleet.replica(unit_key)
        if rep is not None:
            return (f"engine {unit_key} on {self.node_name}: "
                    f"{rep.engine.counters()}\n")
        return self.inner.logs(unit_key)

    def exec(self, unit_key: str, cmd: str) -> str:
        return self.inner.exec(unit_key, cmd)

    def stop(self, unit: WorkUnit) -> None:
        if self._is_engine(unit):
            self.fleet.retire_replica(unit.metadata.key)
        else:
            self.inner.stop(unit)


class EngineReplica:
    """One hosted engine + its dedicated drive thread.

    The drive loop is: take up to ``free_slots`` requests from the shared
    WRR scheduler, fused-admit them, fused-step while slots are active,
    report finished requests to the fleet. When idle it parks on the
    scheduler condvar (its own OS thread — never a cooperative task).
    """

    def __init__(self, key: str, node: str, engine: GenerationEngine,
                 scheduler: SlotScheduler,
                 on_finished: Callable[[Request], None]):
        self.key = key
        self.node = node
        self.engine = engine
        self.scheduler = scheduler
        self.on_finished = on_finished
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._drive, name=f"engine:{key}", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        """Request retirement; the drive loop drains in-flight slots
        (bounded by their token budgets) before exiting."""
        self._stop.set()
        self.scheduler.notify_all()

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)

    def _drive(self) -> None:
        engine = self.engine
        while True:
            # the engine's span lane, if it is traced: this loop's turns
            # go there as replica.take / replica.finish / replica.park
            tr = getattr(engine, "tracer", None)
            stopping = self._stop.is_set()
            if not stopping:
                free = len(engine.free_slots())
                if free:
                    reqs = _spanned(tr, "replica.take", self.scheduler.take,
                                    free)
                    self._report(tr, [req for req in engine.admit_many(reqs)
                                      if req.done])
            if engine.active_slots():
                self._report(tr, engine.step())
                continue
            if stopping:
                return                      # drained
            # idle: park until work arrives (dedicated thread, not a task)
            _spanned(tr, "replica.park", self.scheduler.wait_pending, 0.05)

    def _report(self, tr: Optional[Any], finished: List[Request]) -> None:
        """Hand the finished requests to the fleet (registry, meter, SLO
        and tracer work, on this drive thread)."""
        if not finished:
            return
        t0 = time.monotonic() if tr is not None else 0.0
        for req in finished:
            self.on_finished(req)
        if tr is not None:
            tr.lane_span("replica.finish", t0, time.monotonic())


class ServingFleet(Controller):
    """Seventh controller on the shared runtime: the serving data plane.

    Reconciles ``engine-<i>`` WorkUnits in :data:`SERVING_NS` toward the
    desired replica count, fronts the shared :class:`SlotScheduler`, and
    exports the per-tenant serving metrics."""

    def __init__(self, engine_factory: Callable[[], GenerationEngine], *,
                 replicas: int = 1, fair: bool = True,
                 namespace: str = SERVING_NS, chips_per_replica: int = 1,
                 scan_interval: float = 0.5, name: str = "serving-fleet"):
        super().__init__(name, queue=WorkQueue(name), workers=1,
                         scan_interval=scan_interval,
                         drop_on=(NotFoundError,))
        self.engine_factory = engine_factory
        self.namespace = namespace
        self.chips_per_replica = chips_per_replica
        self.scheduler = SlotScheduler(fair=fair)
        self.desired_replicas = replicas
        self.api: Optional[APIServer] = None
        self.unit_informer: Optional[Any] = None
        self._replicas: Dict[str, EngineReplica] = {}    # unit key -> replica
        self._retired: List[EngineReplica] = []
        self._tenants: Dict[str, int] = {}               # name -> weight
        self._lock = threading.Lock()
        self._done_cv = threading.Condition(self._lock)
        self._uid = 0
        self.completed: Dict[int, Request] = {}
        self.spawned = 0
        self.retired = 0
        # observability wiring (set by attach(): adopted from the framework)
        self.tracer: Optional[Any] = None
        self.slo: Optional[Any] = None
        self.meter: Optional[Any] = None

    # -- wiring ------------------------------------------------------------

    def attach(self, fw: Any) -> "ServingFleet":
        """Wire into a :class:`VirtualClusterFramework`: wrap every node
        agent's provider, watch serving WorkUnits, register with the
        manager (start included if the framework is live), and hand the
        fleet to the autoscaler as its engine actuator."""
        self.api = fw.super_api
        self.tracer = getattr(fw, "tracer", None)
        self.slo = getattr(fw, "slo", None)
        self.meter = getattr(fw, "meter", None)
        for agent in fw.agents.values():
            assert isinstance(agent, NodeAgent)
            agent.provider = EngineProvider(self, agent.node_name,
                                            agent.provider)
        self.unit_informer = self.add_informer(
            fw.super_api, "WorkUnit", handler=self._on_unit,
            name=f"{self.name}/units", namespace=self.namespace)
        fw.manager.add(self)
        if getattr(fw, "autoscaler", None) is not None:
            fw.autoscaler.set_engine_fleet(self)
        return self

    def register_tenant(self, plane: Any, weight: Optional[int] = None
                        ) -> None:
        """Admit a tenant to the serving plane. ``plane`` is a
        :class:`TenantControlPlane` (name + WRR weight) or a plain name."""
        if isinstance(plane, TenantControlPlane):
            name = plane.name
            w = plane.weight if weight is None else weight
        else:
            name, w = str(plane), (1 if weight is None else weight)
        with self._lock:
            self._tenants[name] = max(1, int(w))
        self.scheduler.register_tenant(name, max(1, int(w)))

    # -- request plane -----------------------------------------------------

    def submit(self, tenant: str, prompt: Any,
               max_new_tokens: int = 16) -> int:
        with self._lock:
            if tenant not in self._tenants:
                raise PermissionError(
                    f"tenant {tenant!r} not registered with serving fleet")
            self._uid += 1
            uid = self._uid
        req = Request(uid, np.asarray(prompt, np.int32).reshape(-1),
                      max_new_tokens, tenant=tenant)
        self.scheduler.submit(tenant, req)
        self.metrics.inc("serving_requests_total", tenant=tenant)
        return uid

    def _on_request_finished(self, req: Request) -> None:
        m = self.metrics
        ttft = max(0.0, req.first_token_at - req.submitted_at)
        m.observe("serving_ttft_seconds", ttft, tenant=req.tenant)
        m.observe("serving_ttft_seconds", ttft)     # fleet aggregate
        m.histogram("serving_ttft_seconds", tenant=req.tenant).observe(ttft)
        m.histogram("serving_ttft_seconds").observe(ttft)
        m.inc("serving_tokens_total", float(len(req.tokens)),
              tenant=req.tenant)
        m.inc("serving_tokens_total", float(len(req.tokens)))
        um = self.meter
        if um is not None:
            # slot-seconds: wall time the request held an engine slot
            # (admission -> finish; zero timestamps fall back to the
            # previous boundary, same convention as the span tree)
            admit0 = (req.admit_started_at or req.dequeued_at
                      or req.submitted_at)
            um.add_many(req.tenant, (
                ("serving_requests", 1.0),
                ("tokens", float(len(req.tokens))),
                ("slot_seconds", max(0.0, req.finished_at - admit0)),
                ("ttft_s", ttft)))
        if self.slo is not None:
            self.slo.observe("serving_ttft", req.tenant, ttft)
        if self.tracer is not None:
            self._trace_request(req)
        with self._done_cv:
            self.completed[req.uid] = req
            self._done_cv.notify_all()

    def _trace_request(self, req: Request) -> None:
        """Synthesize the queue->admit->prefill->decode span tree from the
        request's timestamps — the hot decode loop never touches span
        objects; the whole tree is recorded once, at finish."""
        tr = self.tracer
        total = max(0.0, req.finished_at - req.submitted_at)
        keep = (tr.should_sample(req.tenant)
                or total >= tr.slow_threshold_s)
        root = tr.record("serving.request", req.submitted_at,
                         req.finished_at, tenant=req.tenant, keep=keep,
                         sampled=keep,
                         attrs={"uid": req.uid, "tokens": len(req.tokens)})
        if root is None:
            return
        # zero timestamps mean the phase never happened (e.g. finished at
        # admission): fall back to the previous boundary so the tree is
        # always well-formed
        dequeued = req.dequeued_at or req.submitted_at
        admit0 = req.admit_started_at or dequeued
        first = req.first_token_at or req.finished_at
        for name, s, e in (("serving.queue_wait", req.submitted_at, dequeued),
                           ("serving.admit", dequeued, admit0),
                           ("serving.prefill", admit0, first),
                           ("serving.decode", first, req.finished_at)):
            tr.record(name, s, max(s, e), trace_id=root["trace_id"],
                      parent_id=root["span_id"], tenant=req.tenant,
                      keep=True, sampled=keep)

    def wait_completed(self, n: int, timeout: float = 60.0
                       ) -> Dict[int, Request]:
        """Block until ``n`` requests completed (tests/benchmarks; never
        called from a controller entry point)."""
        deadline = time.monotonic() + timeout
        with self._done_cv:
            while len(self.completed) < n:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"{len(self.completed)}/{n} requests completed "
                        f"after {timeout}s")
                self._done_cv.wait(remaining)
            return dict(self.completed)

    def pop_completed(self) -> Dict[int, Request]:
        with self._lock:
            out = self.completed
            self.completed = {}
            return out

    # -- replica lifecycle (called from EngineProvider on agent workers) ---

    def spawn_replica(self, unit_key: str, node_name: str) -> None:
        with self._lock:
            if unit_key in self._replicas:
                return
        engine = self.engine_factory()
        rep = EngineReplica(unit_key, node_name, engine, self.scheduler,
                            self._on_request_finished)
        start = False
        with self._lock:
            if unit_key not in self._replicas:
                self._replicas[unit_key] = rep
                self.spawned += 1
                start = True
        if start:
            rep.start()
            self.metrics.inc("serving_replicas_spawned",
                             controller=self.name)

    def retire_replica(self, unit_key: str) -> None:
        with self._lock:
            rep = self._replicas.pop(unit_key, None)
            if rep is None:
                return
            self.retired += 1
            self._retired.append(rep)
        rep.stop()       # drains in-flight slots on its own thread
        self.metrics.inc("serving_replicas_retired", controller=self.name)

    def replica(self, unit_key: str) -> Optional[EngineReplica]:
        with self._lock:
            return self._replicas.get(unit_key)

    def live_replicas(self) -> int:
        with self._lock:
            return len(self._replicas)

    def free_slots(self) -> int:
        with self._lock:
            reps = list(self._replicas.values())
        return sum(len(r.engine.free_slots()) for r in reps)

    def total_slots(self) -> int:
        with self._lock:
            reps = list(self._replicas.values())
        return sum(r.engine.slots for r in reps)

    # -- desired-state reconciliation --------------------------------------

    def resize(self, n: int) -> int:
        """Set the desired replica count (the autoscaler's actuation) and
        converge WorkUnits toward it. Returns the new desired count."""
        n = max(0, int(n))
        with self._lock:
            self.desired_replicas = n
        self._converge()
        return n

    def _unit_name(self, i: int) -> str:
        return f"engine-{i}"

    def _converge(self) -> None:
        """Create missing / delete surplus ``engine-<i>`` WorkUnits. The
        agents' providers then spawn/retire the live replicas."""
        if self.api is None:
            return
        with self._lock:
            desired = self.desired_replicas
        existing = {u.metadata.name: u
                    for u in self.api.list("WorkUnit", self.namespace,
                                           copy=False)}
        for i in range(desired):
            name = self._unit_name(i)
            if name in existing:
                continue
            unit = WorkUnit()
            unit.metadata.name = name
            unit.metadata.namespace = self.namespace
            unit.metadata.labels["app"] = "generation-engine"
            unit.spec.chips = self.chips_per_replica
            unit.spec.payload = {"role": ENGINE_ROLE}
            try:
                self.api.create(unit)
            except AlreadyExistsError:
                pass
        for name, unit in existing.items():
            idx = _unit_index(name)
            if idx is None or idx < desired:
                continue
            try:
                self.api.delete("WorkUnit", self.namespace, name)
            except NotFoundError:
                pass

    # -- controller hooks --------------------------------------------------

    def on_start(self) -> None:
        m = self.metrics
        m.register_gauge("serving_pending_requests", self.scheduler.pending)
        m.register_gauge("serving_live_replicas",
                         lambda: float(self.live_replicas()))
        m.register_gauge("serving_desired_replicas",
                         lambda: float(self.desired_replicas))
        m.register_gauge("serving_free_slots",
                         lambda: float(self.free_slots()))
        self._converge()

    def _on_unit(self, ev_type: str, unit: WorkUnit) -> None:
        if ev_type in (ADDED, MODIFIED, DELETED):
            self.queue.add(unit.metadata.key)

    def reconcile(self, item: Any) -> None:
        key = str(item)
        name = key.split("/", 1)[1] if "/" in key else key
        cached = self.unit_informer.cache.get(self.namespace, name)
        if cached is None:
            # unit deleted under a live replica (node drain, manual delete):
            # the agent's DELETED path also stops it via the provider, but
            # reconcile closes the race when the agent missed the event
            self.retire_replica(key)

    def scan(self) -> int:
        """Periodic anti-entropy: converge units toward desired count and
        flush scheduler wait stats into per-tenant summaries."""
        self._converge()
        um = self.meter
        for tenant, (n, mean_wait) in \
                self.scheduler.tenant_wait_stats().items():
            # observe_n takes the PER-OBSERVATION value (it multiplies by
            # n itself); passing mean_wait*n here used to inflate the
            # summary to sum=mean*n^2 and max=mean*n
            self.metrics.observe_n("serving_queue_wait_seconds",
                                   mean_wait, n, tenant=tenant)
            if um is not None:
                um.add_many(tenant, (("queue_items", float(n)),
                                     ("queue_wait_s", mean_wait * n)))
        return 0

    def on_stop(self) -> None:
        with self._lock:
            reps = list(self._replicas.values()) + self._retired
            self._replicas.clear()
            self._retired = []
        for rep in reps:
            rep.stop()
        for rep in reps:
            rep.join(timeout=30.0)


def _spanned(tr: Optional[Any], name: str, fn: Callable[..., Any],
             *args: Any) -> Any:
    """``fn(*args)``, recorded as span ``name`` on ``tr``'s lane when
    ``tr`` is not None."""
    if tr is None:
        return fn(*args)
    t0 = time.monotonic()
    out = fn(*args)
    tr.lane_span(name, t0, time.monotonic())
    return out


def _unit_index(name: str) -> Optional[int]:
    if not name.startswith("engine-"):
        return None
    try:
        return int(name.split("-", 1)[1])
    except ValueError:
        return None
