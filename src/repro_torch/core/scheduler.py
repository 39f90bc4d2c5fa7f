"""Super-cluster scheduler.

Faithful to the paper's observed behaviour (§IV-A): a single queue, Pods
scheduled sequentially — "the default Kubernetes scheduler has a single queue,
and it schedules Pod sequentially ... throughput peaked at a few hundred Pods
per second". This sequential scheduler is deliberately the reproduction
baseline; ``parallel_scorers`` enables the beyond-paper improvement measured
in EXPERIMENTS.md §Perf (control-plane track).

Runs on the shared controller runtime: a single worker drains a delaying
queue fed by the WorkUnit informer; failed placements retry with per-key
exponential backoff; vanished units are dropped. Under the cooperative
executor the worker is a pool task and retry delays ride the shared timer
wheel; the blocking-thread fallback keeps the legacy shape.

Scheduling honours:
- chip capacity (bin packing, least-allocated scoring);
- node selectors;
- inter-WorkUnit anti-affinity (the vNode semantics of paper Fig.6);
- straggler avoidance: nodes with high heartbeat latency are de-prioritized.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List

from .apiserver import APIServer
from .objects import Node, WorkUnit
from .runtime import Controller
from .store import ADDED, MODIFIED, NotFoundError
from .workqueue import DelayingQueue


class SuperScheduler(Controller):
    def __init__(self, api: APIServer, *, parallel_scorers: int = 0,
                 straggler_penalty_ms: float = 50.0):
        super().__init__("scheduler", queue=DelayingQueue("sched"), workers=1,
                         retry_on=(Exception,), drop_on=(NotFoundError,))
        self.api = api
        self.parallel_scorers = parallel_scorers
        self.straggler_penalty_ms = straggler_penalty_ms
        self.node_informer = self.add_informer(api, "Node", name="sched/nodes")
        self.unit_informer = self.add_informer(api, "WorkUnit",
                                               handler=self._on_unit,
                                               name="sched/units")
        self._alloc_lock = threading.Lock()
        # scheduler-local view of allocatable chips (authoritative between binds)
        self._alloc: Dict[str, int] = {}
        self.scheduled_count = 0
        self.failed_count = 0
        self.bind_latency_sum = 0.0

    # -- lifecycle hooks ---------------------------------------------------------

    def on_start(self) -> None:
        with self._alloc_lock:
            for n in self.node_informer.cache.list():
                self._alloc[n.metadata.name] = n.status.allocatable_chips

    # -- event handlers ----------------------------------------------------------

    def _on_unit(self, ev_type: str, unit: WorkUnit) -> None:
        if ev_type in (ADDED, MODIFIED) and unit.status.phase == "Pending":
            self.queue.add((unit.metadata.namespace, unit.metadata.name))

    def node_failed(self, node_name: str) -> None:
        """Fault tolerance: re-queue every unit bound to a dead node."""
        with self._alloc_lock:
            self._alloc.pop(node_name, None)
        for u in self.unit_informer.cache.list():
            if u.status.node == node_name and u.status.phase != "Failed":
                try:
                    self.api.update_status(
                        "WorkUnit", u.metadata.namespace, u.metadata.name,
                        _mark_pending_again(node_name))
                except NotFoundError:
                    pass

    def node_restored(self, node_name: str, chips: int) -> None:
        with self._alloc_lock:
            self._alloc[node_name] = chips

    # -- reconcile (the paper's sequential bottleneck: workers == 1) -------------

    def reconcile(self, item: Any) -> None:
        ns, name = item
        self._schedule_one(ns, name)

    def _schedule_one(self, ns: str, name: str) -> None:
        unit = self.unit_informer.cache.get(ns, name)
        if unit is None or unit.status.phase != "Pending":
            return
        t0 = time.monotonic()
        nodes = self.node_informer.cache.list()
        feasible = self._filter(unit, nodes)
        if not feasible:
            self.failed_count += 1
            raise RuntimeError(f"no feasible node for {ns}/{name}")
        best = self._score(unit, feasible)
        with self._alloc_lock:
            if self._alloc.get(best.metadata.name, 0) < unit.spec.chips:
                raise RuntimeError("allocation raced; retry")
            self._alloc[best.metadata.name] -= unit.spec.chips
        self.api.update_status("WorkUnit", ns, name, _bind_to(best.metadata.name))
        self.api.update_status("Node", "", best.metadata.name,
                               _consume_chips(unit.spec.chips))
        self.scheduled_count += 1
        self.bind_latency_sum += time.monotonic() - t0

    # -- filter & score -------------------------------------------------------------

    def _filter(self, unit: WorkUnit, nodes: List[Node]) -> List[Node]:
        anti = set(unit.spec.anti_affinity)
        conflict_nodes = set()
        if anti:
            for u in self.unit_informer.cache.list():
                if u.status.node and anti & set(u.metadata.labels.get("group", "").split(",")):
                    conflict_nodes.add(u.status.node)

        def ok(n: Node) -> bool:
            if n.status.phase != "Ready":
                return False
            with self._alloc_lock:
                if self._alloc.get(n.metadata.name, 0) < unit.spec.chips:
                    return False
            for k, v in unit.spec.node_selector.items():
                if n.metadata.labels.get(k) != v:
                    return False
            if n.metadata.name in conflict_nodes:
                return False
            return True

        if self.parallel_scorers > 1:
            with ThreadPoolExecutor(self.parallel_scorers) as ex:
                mask = list(ex.map(ok, nodes))
            return [n for n, m in zip(nodes, mask) if m]
        return [n for n in nodes if ok(n)]

    def _score(self, unit: WorkUnit, nodes: List[Node]) -> Node:
        def score(n: Node) -> float:
            with self._alloc_lock:
                free = self._alloc.get(n.metadata.name, 0)
            s = free / max(1, n.status.capacity_chips)       # least-allocated
            s -= (n.status.heartbeat_latency_ms / self.straggler_penalty_ms) * 0.1
            return s
        return max(nodes, key=score)

    def pending_count(self) -> int:
        return len(self.queue)


def _bind_to(node_name: str):
    def mutate(u: WorkUnit) -> None:
        u.status.phase = "Scheduled"
        u.status.node = node_name
        u.status.set_condition("PodScheduled", "True", "Scheduled")
    return mutate


def _consume_chips(chips: int):
    def mutate(n: Node) -> None:
        n.status.allocatable_chips = max(0, n.status.allocatable_chips - chips)
    return mutate


def _mark_pending_again(dead_node: str):
    def mutate(u: WorkUnit) -> None:
        u.status.phase = "Pending"
        u.status.node = ""
        u.status.restart_count += 1
        u.status.message = f"rescheduled: node {dead_node} failed"
        u.status.set_condition("PodScheduled", "False", "NodeFailed")
        u.status.set_condition("Ready", "False", "NodeFailed")
    return mutate
