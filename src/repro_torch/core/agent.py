"""Node agents: the kubelet analogue and the paper's vn-agent proxy.

NodeAgent watches WorkUnits bound to its node and drives them to Ready via a
Provider. ``MockProvider`` reproduces the paper's virtual-kubelet mock ("marks
all Pods scheduled to the virtual kubelet ready and running instantaneously")
used in the large-scale experiments; ``CallableProvider`` executes real work
(a JAX step function) for the end-to-end examples.

NodeAgent runs on the shared controller runtime: the WorkUnit informer
enqueues units bound to this node, a single worker drives them through the
Provider, and the periodic scan doubles as the kubelet heartbeat.

VnAgent (paper Fig.4 (3)): tenants cannot reach the kubelet, so log/exec
requests go to a per-node proxy that identifies the tenant by comparing the
hash of its TLS credential with the ones saved in VC objects, then translates
the tenant namespace to the super-cluster namespace prefix.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from .apiserver import APIServer
from .objects import Node, NodeStatus, WorkUnit
from .runtime import Controller, RetryLater
from .store import ADDED, AlreadyExistsError, DELETED, MODIFIED, NotFoundError
from .upward import EventRecorder
from .workqueue import WorkQueue


class Provider:
    """Pod runtime interface (CRI analogue, full Pod semantics — unlike
    virtual-kubelet's reduced ~7-call interface, see paper §II)."""

    def run(self, unit: WorkUnit) -> None:          # -> Running
        raise NotImplementedError

    def wait_ready(self, unit: WorkUnit) -> None:   # -> Ready
        raise NotImplementedError

    def logs(self, unit_key: str) -> str:
        return ""

    def exec(self, unit_key: str, cmd: str) -> str:
        return ""

    def stop(self, unit: WorkUnit) -> None:
        pass


class MockProvider(Provider):
    """Instant-ready mock (virtual-kubelet experiment rig)."""

    def __init__(self):
        self._logs: Dict[str, str] = {}

    def run(self, unit: WorkUnit) -> None:
        self._logs[unit.metadata.key] = f"started {unit.metadata.key}\n"

    def wait_ready(self, unit: WorkUnit) -> None:
        pass

    def logs(self, unit_key: str) -> str:
        return self._logs.get(unit_key, "")

    def exec(self, unit_key: str, cmd: str) -> str:
        return f"$ {cmd}\nok\n"


class CallableProvider(Provider):
    """Runs a user callable per WorkUnit (the JAX step executor)."""

    def __init__(self, fn: Callable[[WorkUnit], Any]):
        self.fn = fn
        self._logs: Dict[str, str] = {}
        self.results: Dict[str, Any] = {}

    def run(self, unit: WorkUnit) -> None:
        key = unit.metadata.key
        t0 = time.monotonic()
        out = self.fn(unit)
        self.results[key] = out
        self._logs[key] = (self._logs.get(key, "")
                           + f"ran {key} in {time.monotonic()-t0:.3f}s -> {out}\n")

    def wait_ready(self, unit: WorkUnit) -> None:
        pass

    def logs(self, unit_key: str) -> str:
        return self._logs.get(unit_key, "")

    def exec(self, unit_key: str, cmd: str) -> str:
        return f"$ {cmd}\n{self.results.get(unit_key)}\n"


class NodeAgent(Controller):
    """kubelet analogue: one per physical node, registered to the super only."""

    def __init__(self, api: APIServer, node_name: str, chips: int = 8,
                 chip_ids: Optional[List[int]] = None,
                 provider: Optional[Provider] = None,
                 router: Optional[Any] = None,
                 heartbeat_interval: float = 5.0,
                 record_events: bool = True):
        super().__init__(f"agent-{node_name}",
                         queue=WorkQueue(f"agent-{node_name}"), workers=1,
                         scan_interval=heartbeat_interval,
                         retry_on=(RetryLater,))
        self.api = api
        self.node_name = node_name
        self.chips = chips
        self.chip_ids = chip_ids or []
        self.provider = provider or MockProvider()
        self.router = router
        self.heartbeat_interval = heartbeat_interval
        # kubelet-style event recording: WorkUnit phase transitions and node
        # heartbeats become deduplicated Events in the super cluster, synced
        # upward so tenants can list them (count/lastTimestamp compression
        # keeps the periodic heartbeat at ONE stored object per node)
        self.events: Optional[EventRecorder] = (
            EventRecorder(api, f"node-agent/{node_name}", host=node_name)
            if record_events else None)
        self.unit_informer = self.add_informer(api, "WorkUnit",
                                               handler=self._on_unit,
                                               name=f"kubelet:{node_name}")
        self._running_units: Dict[str, WorkUnit] = {}
        self.ran_count = 0

    def register(self) -> None:
        node = Node()
        node.metadata.name = self.node_name
        node.metadata.labels["topology/host"] = self.node_name
        node.status = NodeStatus(capacity_chips=self.chips,
                                 allocatable_chips=self.chips,
                                 heartbeat_time=time.time())
        node.chip_ids = list(self.chip_ids)
        try:
            self.api.create(node)
        except AlreadyExistsError:
            pass  # re-registration after restart

    def on_start(self) -> None:
        self.register()

    # -- unit lifecycle ----------------------------------------------------------

    def _on_unit(self, ev_type: str, unit: WorkUnit) -> None:
        if (ev_type in (ADDED, MODIFIED)
                and unit.status.node == self.node_name
                and unit.status.phase == "Scheduled"):
            self.queue.add((unit.metadata.namespace, unit.metadata.name))
        elif ev_type == DELETED and unit.status.node == self.node_name:
            # deletion of a unit this node ran: release provider resources
            self.queue.add((unit.metadata.namespace, unit.metadata.name))

    def reconcile(self, item: Any) -> None:
        ns, name = item
        unit = self.unit_informer.cache.get(ns, name)
        if unit is not None:
            self._maybe_run(unit)
            return
        # gone from the cache: stop whatever the provider is running for it
        # (also unblocks re-running a recreated unit with the same key)
        key = f"{ns}/{name}" if ns else name
        running = self._running_units.pop(key, None)
        if running is not None:
            self.provider.stop(running)

    def _maybe_run(self, unit: WorkUnit) -> None:
        if unit.status.node != self.node_name:
            return
        if unit.status.phase != "Scheduled":
            return
        key = unit.metadata.key
        if key in self._running_units:
            return
        self._running_units[key] = unit
        # init-gate (paper §III-B (4)): routing rules must be injected before
        # the workload starts — the init-container handshake. On the shared
        # executor, blocking 30 s here would park a pool thread (and could
        # starve the router task that opens the gate), so poll the gate and
        # requeue with backoff instead.
        if unit.spec.init_gate and self.router is not None:
            timeout = 30.0 if self.executor is None else 0.0
            if (not self.router.wait_for_rules(unit.metadata.uid,
                                               timeout=timeout)
                    and self.executor is not None):
                del self._running_units[key]
                raise RetryLater(f"routing rules pending for {key}")
        try:
            self.provider.run(unit)
            self._set_phase(unit, "Running")
            self.provider.wait_ready(unit)
            self._set_phase(unit, "Ready")
            self.ran_count += 1
        except Exception as e:  # pragma: no cover - defensive
            self._set_phase(unit, "Failed", str(e))

    _PHASE_REASONS = {"Running": "Started", "Ready": "Ready",
                      "Failed": "Failed"}

    def _set_phase(self, unit: WorkUnit, phase: str, msg: str = "") -> None:
        def mutate(u: WorkUnit) -> None:
            u.status.phase = phase
            u.status.message = msg
            if phase == "Ready":
                u.status.set_condition("Ready", "True", "WorkloadReady")
        try:
            self.api.update_status("WorkUnit", unit.metadata.namespace,
                                   unit.metadata.name, mutate)
        except NotFoundError:
            return
        if self.events is not None:
            self.events.record(
                "WorkUnit", unit.metadata.namespace, unit.metadata.name,
                self._PHASE_REASONS.get(phase, phase),
                msg or f"{phase} on {self.node_name}",
                type="Warning" if phase == "Failed" else "Normal")

    # -- heartbeat (rides the runtime's periodic scan) ---------------------------

    def scan(self) -> int:
        t0 = time.monotonic()
        try:
            self.api.update_status("Node", "", self.node_name, _beat(t0))
        except NotFoundError:
            pass
        if self.events is not None:
            # cluster-scoped, compresses to one object (count++) per node
            self.events.record("Node", "", self.node_name, "Heartbeat",
                               f"kubelet {self.node_name} heartbeat")
        return 0


def _beat(t0: float):
    def mutate(n: Node) -> None:
        n.status.heartbeat_time = time.time()
        n.status.heartbeat_latency_ms = (time.monotonic() - t0) * 1e3
    return mutate


class VnAgent:
    """Per-node proxy for tenant log/exec requests (paper Fig.4 (3)).

    The tenant apiserver cannot reach the kubelet; its virtual nodes point
    here instead. Tenant identity is resolved by the credential hash saved in
    each VC object, which determines the namespace prefix translation.
    """

    def __init__(self, super_api: APIServer, agents: Dict[str, NodeAgent]):
        self.super_api = super_api
        self.agents = agents
        # credential-hash -> (vc name, namespace prefix)
        self._tenants: Dict[str, str] = {}
        self._lock = threading.Lock()
        self.proxied = 0

    def register_tenant(self, credential: str, ns_prefix: str) -> None:
        h = hashlib.sha256(credential.encode()).hexdigest()[:16]
        with self._lock:
            self._tenants[h] = ns_prefix

    def _resolve(self, credential: str, tenant_ns: str) -> str:
        h = hashlib.sha256(credential.encode()).hexdigest()[:16]
        with self._lock:
            prefix = self._tenants.get(h)
        if prefix is None:
            raise PermissionError("unknown tenant credential")
        return f"{prefix}-{tenant_ns}"

    def logs(self, credential: str, node: str, tenant_ns: str, name: str) -> str:
        super_ns = self._resolve(credential, tenant_ns)
        agent = self.agents.get(node)
        if agent is None:
            raise NotFoundError(f"node {node} not found")
        with self._lock:
            self.proxied += 1
        return agent.provider.logs(f"{super_ns}/{name}")

    def exec(self, credential: str, node: str, tenant_ns: str, name: str,
             cmd: str) -> str:
        super_ns = self._resolve(credential, tenant_ns)
        agent = self.agents.get(node)
        if agent is None:
            raise NotFoundError(f"node {node} not found")
        with self._lock:
            self.proxied += 1
        return agent.provider.exec(f"{super_ns}/{name}", cmd)
