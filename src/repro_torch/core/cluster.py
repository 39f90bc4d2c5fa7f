"""Top-level wiring: a complete VirtualCluster deployment in one object.

Composes the super cluster (apiserver + scheduler + node agents + router +
vn-agent), the (optionally sharded) syncer, and the tenant operator — all
registered, in dependency order, with one :class:`ControllerManager` that
owns lifecycle, health, and the process-wide metrics registry. This is the
public entry point used by examples, tests, and the paper-replication
benchmarks.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .agent import MockProvider, NodeAgent, Provider, VnAgent
from .apiserver import APIServer, TenantControlPlane
from .audit import AuditLog
from .autoscaler import Autoscaler, ScalingPolicy
from .executor import CooperativeExecutor
from .metering import UsageMeter
from .objects import VirtualClusterCR, WorkUnit, WorkUnitSpec
from .router import MeshRouter
from .runtime import (PROMETHEUS_CONTENT_TYPE, ControllerManager,
                      MetricsRegistry, prometheus_text)
from .scheduler import SuperScheduler
from .slo import SLOTracker
from .store import NotFoundError
from .syncer import Syncer
from .tenant_operator import TenantOperator
from .trace import TRACEPARENT_KEY, Tracer


class VirtualClusterFramework:
    """One VirtualCluster deployment.

    ``executor_mode`` (default on) runs every controller — informer pumps,
    reconcile workers, periodic scans — on one shared
    :class:`CooperativeExecutor` of ``executor_pool`` OS threads, so thread
    count stays O(pool size) no matter how many tenants register.
    ``executor_mode=False`` is the legacy blocking-thread fallback
    (one thread per informer/worker/scan loop).

    The upward status/event path mirrors the downward one: tenant-hash
    upward shards (``upward_shards``, default = ``syncer_shards``) with
    per-object latest-wins coalescing and batched tenant-plane writes
    (``batch_upward``, on by default), plus kubelet-style Events recorded by
    the node agents (``record_events``) and synced into tenant planes with
    their dedup counts.

    ``autoscale=True`` adds the closed-loop :class:`Autoscaler` as a sixth
    controller: it grows/shrinks the downward shard fleet
    (``Syncer.resize_shards``) from fair-queue depth and reconcile latency,
    the upward fleet (``Syncer.resize_upward_shards``) from upward-queue
    depth and upward sync latency, and resizes the cooperative executor
    pool from ready-backlog and quantum-latency signals, within
    ``autoscale_policy`` bounds. With ``autoscale=False`` (default) the
    fleet stays exactly as configured.
    """

    def __init__(self, *, num_nodes: int = 4, chips_per_node: int = 8,
                 downward_workers: int = 20, upward_workers: int = 100,
                 fair_queuing: bool = True, scan_interval: float = 60.0,
                 router_scan_interval: float = 60.0,
                 provider_factory: Optional[Callable[[str], Provider]] = None,
                 parallel_scorers: int = 0,
                 heartbeat_interval: float = 5.0,
                 grpc_latency_ms: float = 0.0,
                 syncer_shards: int = 1,
                 downward_batch: int = 1,
                 upward_shards: Optional[int] = None,
                 batch_upward: bool = True,
                 upward_batch: int = 16,
                 record_events: bool = True,
                 executor_mode: bool = True,
                 executor_pool: int = 8,
                 autoscale: bool = False,
                 autoscale_policy: Optional[ScalingPolicy] = None,
                 autoscale_interval: float = 0.5,
                 tracing: bool = False,
                 tracer: Optional[Tracer] = None,
                 metering: bool = False,
                 meter: Optional[UsageMeter] = None,
                 audit: bool = False,
                 audit_log: Optional[AuditLog] = None):
        self.executor = (CooperativeExecutor(executor_pool, name="vc-exec")
                         if executor_mode else None)
        # distributed tracing is opt-in (tracing=True, or pass a configured
        # Tracer); every hook in the planes guards on `tracer is not None`,
        # so the default deployment is byte-identical to an untraced one
        self.tracer: Optional[Tracer] = (
            tracer if tracer is not None else (Tracer() if tracing else None))
        # usage metering and the audit trail follow the same opt-in contract:
        # every hook guards on `meter/audit is not None`, so metering=False
        # (the default) leaves the hot paths byte-identical to the unmetered
        # deployment
        self.meter: Optional[UsageMeter] = (
            meter if meter is not None else (UsageMeter() if metering
                                             else None))
        self.audit: Optional[AuditLog] = (
            audit_log if audit_log is not None else (AuditLog() if audit
                                                     else None))
        # per-tenant SLO accounting is always on: a handful of ints per
        # rolling bucket, fed by the upward pipeline and the serving plane
        self.slo = SLOTracker()
        self.manager = ControllerManager(executor=self.executor)
        self.super_api = APIServer("super")
        self.super_api.store.tracer = self.tracer
        self.router = MeshRouter(self.super_api,
                                 grpc_latency_ms=grpc_latency_ms,
                                 scan_interval=router_scan_interval)
        self.agents: Dict[str, NodeAgent] = {}
        for i in range(num_nodes):
            name = f"node-{i:04d}"
            provider = (provider_factory(name) if provider_factory
                        else MockProvider())
            chip_ids = list(range(i * chips_per_node, (i + 1) * chips_per_node))
            self.agents[name] = NodeAgent(
                self.super_api, name, chips=chips_per_node, chip_ids=chip_ids,
                provider=provider, router=self.router,
                heartbeat_interval=heartbeat_interval,
                record_events=record_events)
        self.vn_agent = VnAgent(self.super_api, self.agents)
        self.scheduler = SuperScheduler(self.super_api,
                                        parallel_scorers=parallel_scorers)
        self.syncer = Syncer(self.super_api,
                             downward_workers=downward_workers,
                             upward_workers=upward_workers,
                             fair_queuing=fair_queuing,
                             scan_interval=scan_interval,
                             shards=syncer_shards,
                             downward_batch=downward_batch,
                             upward_shards=upward_shards,
                             batch_upward=batch_upward,
                             upward_batch=upward_batch,
                             record_events=record_events,
                             executor=self.executor,
                             tracer=self.tracer)
        self.syncer.slo = self.slo
        if self.meter is not None:
            # sync-lane occupancy + per-item bandwidth, attributed per tenant
            self.syncer.meter = self.meter
            # windowed gauges (noisy-tenant count, tracked tenants) ride the
            # shared registry so /metrics exports them alongside everything
            self.meter.bind(self.manager.metrics)
        self.operator = TenantOperator(self.super_api, self.syncer,
                                       vn_agents=[self.vn_agent])
        # the operator stamps audit/meter onto every tenant plane it
        # provisions, before syncer registration — first request attributed
        self.operator.audit = self.audit
        self.operator.meter = self.meter
        # registration order == start order; stop runs in reverse
        self.manager.add(*self.agents.values())
        self.manager.add(self.router)
        self.manager.add(self.scheduler)
        self.manager.add(*self.syncer.controllers)
        self.syncer.manager = self.manager   # resize_shards stays in sync
        self.manager.add(self.operator)
        # closed-loop autoscaler: sixth controller on the shared runtime.
        # Watches fair-queue depth / reconcile latency / executor backlog
        # and actuates resize_shards + executor.resize. Off by default:
        # autoscale=False keeps the fleet exactly as configured above.
        self.autoscaler: Optional[Autoscaler] = None
        if autoscale:
            # copy before widening: the caller's policy object stays pristine
            # (it may be shared across frameworks)
            policy = dataclasses.replace(autoscale_policy or ScalingPolicy())
            # widen the bounds to include the configured starting sizes so
            # the loop never finds itself outside its own [min, max] box
            policy.min_shards = min(policy.min_shards, syncer_shards)
            policy.max_shards = max(policy.max_shards, syncer_shards)
            start_upward = self.syncer.num_upward_shards
            policy.min_upward_shards = min(policy.min_upward_shards,
                                           start_upward)
            policy.max_upward_shards = max(policy.max_upward_shards,
                                           start_upward)
            if self.executor is not None:
                policy.min_pool = min(policy.min_pool, executor_pool)
                policy.max_pool = max(policy.max_pool, executor_pool)
            self.autoscaler = Autoscaler(self.syncer, self.executor,
                                         policy=policy,
                                         interval=autoscale_interval)
            # advisory input only: the weight autotuner dampens tenants the
            # dominant-share detector currently flags as noisy
            self.autoscaler.meter = self.meter
            self.manager.add(self.autoscaler)
        self._started = False
        self._metrics_server: Optional[Any] = None
        self._metrics_thread: Optional[threading.Thread] = None

    # -- lifecycle --------------------------------------------------------------

    @property
    def metrics(self) -> MetricsRegistry:
        """Process-wide controller metrics (queue depth, reconcile latency,
        retries, scan cost) for every controller in the framework."""
        return self.manager.metrics

    def healthy(self) -> Dict[str, bool]:
        return self.manager.healthy()

    def serve_metrics(self, port: int = 0, host: str = "127.0.0.1") -> int:
        """Serve the shared :class:`MetricsRegistry` snapshot as JSON over
        HTTP (stdlib ``http.server``; one acceptor daemon thread plus a
        short-lived daemon thread per request). Routes:

        - ``/`` or ``/metrics`` — ``MetricsRegistry.snapshot()`` (counters,
          summaries, gauges, histograms — including the executor and
          autoscaler gauges). With ``?format=prom`` — or an ``Accept``
          header naming ``text/plain`` or ``openmetrics`` — the same
          snapshot is rendered in Prometheus text exposition format 0.0.4
          instead of JSON;
        - ``/healthz`` — ``{"controllers": <per-controller health map>,
          "autoscaler": <loop state or null>, "slo": <per-tenant SLO
          compliance/burn-rate map>, "usage": <noisy-neighbor summary or
          null>}``, 503 if any controller is unhealthy. The autoscaler
          state (last decision, current targets, cooldown remaining,
          signal windows) makes a wedged control loop visible from outside
          the process;
        - ``/usage`` — the :class:`UsageMeter` state: rolling-window
          per-tenant consumption by resource axis, exact lifetime totals,
          dominant-share scores and currently-noisy tenants
          (``{"enabled": false}`` when metering is off);
        - ``/audit`` — the :class:`AuditLog` state: per-tenant/verb counts
          plus the retained record rings, filterable with
          ``?tenant=&verb=&kind=&limit=`` query params
          (``{"enabled": false}`` when auditing is off);
        - ``/traces`` — the tracer's retained span ring as JSON
          (``{"enabled", "stats", "spans"}``; empty when tracing is off);
          ``/traces/chrome`` (or ``/traces?format=chrome``) returns the
          same ring as Chrome trace-event JSON, loadable directly in
          Perfetto / ``chrome://tracing``.

        Returns the bound port (pass ``port=0`` for an ephemeral one).
        """
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        if self._metrics_server is not None:
            return self._metrics_server.server_port
        fw = self

        class Handler(BaseHTTPRequestHandler):
            def _wants_prom(self, query: str) -> bool:
                if "format=prom" in query:
                    return True
                accept = (self.headers.get("Accept") or "").lower()
                return "text/plain" in accept or "openmetrics" in accept

            def do_GET(self) -> None:
                path, _, query = self.path.partition("?")
                tr = fw.tracer
                ctype = "application/json"
                if path in ("/", "/metrics"):
                    snap = fw.metrics.snapshot()
                    if self._wants_prom(query):
                        code = 200
                        body = prometheus_text(snap).encode()
                        ctype = PROMETHEUS_CONTENT_TYPE
                        self._reply(code, body, ctype)
                        return
                    code, payload = 200, snap
                elif path == "/healthz":
                    health = fw.healthy()
                    code = 200 if all(health.values()) else 503
                    payload = {"controllers": health,
                               "autoscaler": (fw.autoscaler.state()
                                              if fw.autoscaler else None),
                               "slo": fw.slo.state(),
                               "usage": (fw.meter.noisy_state()
                                         if fw.meter is not None else None)}
                elif path == "/usage":
                    code = 200
                    payload = (fw.meter.state() if fw.meter is not None
                               else {"enabled": False})
                elif path == "/audit":
                    code = 200
                    au = fw.audit
                    if au is None:
                        payload = {"enabled": False}
                    else:
                        import urllib.parse
                        q = urllib.parse.parse_qs(query)

                        def first(key: str) -> Optional[str]:
                            vals = q.get(key)
                            return vals[0] if vals else None

                        try:
                            limit = int(first("limit") or 256)
                        except ValueError:
                            limit = 256
                        payload = au.state(tenant=first("tenant"),
                                           verb=first("verb"),
                                           kind=first("kind"),
                                           limit=limit)
                elif path == "/traces/chrome" or (
                        path == "/traces" and "format=chrome" in query):
                    code = 200
                    payload = (tr.chrome_trace() if tr is not None
                               else {"traceEvents": []})
                elif path == "/traces":
                    code = 200
                    payload = {"enabled": tr is not None,
                               "stats": tr.stats() if tr is not None else {},
                               "spans": tr.spans() if tr is not None else []}
                else:
                    code, payload = 404, {"error": f"no route {self.path}"}
                self._reply(code, json.dumps(payload, default=str).encode(),
                            ctype)

            def _reply(self, code: int, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args: Any) -> None:
                pass   # keep benchmark/test output clean

        # threading server: a slow/hung probe must not block later /healthz
        self._metrics_server = ThreadingHTTPServer((host, port), Handler)
        self._metrics_thread = threading.Thread(
            target=self._metrics_server.serve_forever,
            name="metrics-http", daemon=True)
        self._metrics_thread.start()
        return self._metrics_server.server_port

    def start(self) -> None:
        self.manager.start()
        self._started = True

    def stop(self) -> None:
        if self._metrics_server is not None:
            self._metrics_server.shutdown()
            self._metrics_server.server_close()
            self._metrics_server = None
            self._metrics_thread = None
        # the scaling loop dies first: shards it added registered with the
        # manager AFTER it, so reverse-order stop would tear them down while
        # a live tick could still resize (and restart) them
        if self.autoscaler is not None:
            self.autoscaler.stop()
        self.manager.stop()
        self.super_api.close()

    def __enter__(self) -> "VirtualClusterFramework":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- tenants -----------------------------------------------------------------

    def add_tenant(self, name: str, weight: int = 1,
                   timeout: float = 10.0) -> TenantControlPlane:
        vc = VirtualClusterCR()
        vc.metadata.name = name
        vc.weight = weight
        self.super_api.create(vc)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            plane = self.operator.planes.get(name)
            if plane is not None and name in self.syncer.tenants:
                return plane
            time.sleep(0.005)
        raise TimeoutError(f"tenant {name} not provisioned in {timeout}s")

    def remove_tenant(self, name: str) -> None:
        self.super_api.delete("VirtualClusterCR", "", name)

    # -- workload helpers --------------------------------------------------------------

    @staticmethod
    def make_unit(name: str, namespace: str = "default", *, arch: str = "tiny-dense",
                  shape: str = "train_4k", chips: int = 1,
                  anti_affinity: Optional[List[str]] = None,
                  labels: Optional[Dict[str, str]] = None,
                  init_gate: bool = False,
                  payload: Optional[Dict[str, Any]] = None) -> WorkUnit:
        unit = WorkUnit()
        unit.metadata.name = name
        unit.metadata.namespace = namespace
        unit.metadata.labels.update(labels or {})
        unit.spec = WorkUnitSpec(arch=arch, shape=shape, chips=chips,
                                 anti_affinity=anti_affinity or [],
                                 init_gate=init_gate, payload=payload or {})
        return unit

    def submit(self, plane: TenantControlPlane, unit: WorkUnit) -> WorkUnit:
        try:
            plane.api.get("Namespace", "", unit.metadata.namespace)
        except NotFoundError:
            from .objects import Namespace
            ns = Namespace()
            ns.metadata.name = unit.metadata.namespace
            plane.api.create(ns)
        tr = self.tracer
        if tr is not None:
            # open the end-to-end propagation span here, at the tenant-plane
            # write; its traceparent rides the object's annotations through
            # downward sync and the super commit, and the upward pipeline
            # closes it when the first real status lands back in the tenant
            span = tr.start_pending(
                "propagation", tenant=plane.name,
                attrs={"kind": type(unit).kind,
                       "ns": unit.metadata.namespace,
                       "name": unit.metadata.name})
            # only sampled traces ride the object: every downstream hook
            # skips unsampled carriers, so stamping flag-00 would buy
            # nothing and the annotation is deep-copied on every pipeline
            # hop — head sampling keeps the unsampled path annotation-free
            if span.sampled:
                unit.metadata.annotations[TRACEPARENT_KEY] = \
                    span.traceparent()
        return plane.api.create(unit)

    @staticmethod
    def wait_ready(plane: TenantControlPlane, namespace: str, name: str,
                   timeout: float = 60.0) -> WorkUnit:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                unit = plane.api.get("WorkUnit", namespace, name)
                if unit.status.phase == "Ready":
                    return unit
                if unit.status.phase == "Failed":
                    raise RuntimeError(f"unit failed: {unit.status.message}")
            except NotFoundError:
                pass
            time.sleep(0.01)
        raise TimeoutError(f"{namespace}/{name} not Ready in {timeout}s")

    @staticmethod
    def wait_all_ready(plane: TenantControlPlane, namespace: str,
                       count: int, timeout: float = 300.0,
                       poll: float = 0.05) -> float:
        """Block until ``count`` units in ``namespace`` are Ready; returns
        the wall time spent waiting."""
        t0 = time.monotonic()
        deadline = t0 + timeout
        while time.monotonic() < deadline:
            # read-only poll: shared refs, no deepcopy of the whole namespace
            units = plane.api.list("WorkUnit", namespace, copy=False)
            ready = sum(1 for u in units if u.status.phase == "Ready")
            if ready >= count:
                return time.monotonic() - t0
            time.sleep(poll)
        raise TimeoutError(
            f"only {ready}/{count} units Ready after {timeout}s")
