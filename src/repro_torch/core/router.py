"""MeshRouter — the enhanced-kubeproxy + Kata-agent analogue (paper §III-B (4,5)).

In the paper, cluster-IP service routing breaks when container traffic
bypasses the host network stack (VPC/ENI); the fix injects routing rules into
each Kata guest's IPtable over a secure gRPC channel, and an init-container
gates workload start on rule injection.

TPU adaptation: a tenant's "VPC" is its mesh slice. Each WorkUnit gets a
guest routing table mapping service virtual addresses -> endpoint WorkUnits
(e.g. prefill->decode disaggregation, parameter servers). The router runs on
the shared controller runtime — Service/WorkUnit informers enqueue
``(unit_uid, namespace)`` keys, workers inject rules into per-WorkUnit guest
tables *before* the workload starts (``wait_for_rules`` is the
init-container handshake), and a periodic reconcile scan covers all guest
tables (paper §IV-E measures its cost). On the cooperative executor the
workers and scan are pool tasks; node agents then poll the init gate with
backoff (``RetryLater``) rather than blocking a pool thread on it.

It also **validates collective isolation**: parses compiled HLO and asserts
that every collective's replica groups stay inside the tenant's slice — the
TPU-native expression of "traffic must not leave the VPC".
"""
from __future__ import annotations

import re
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Set

from .apiserver import APIServer
from .runtime import Controller
from .store import DELETED
from .workqueue import WorkQueue


class IsolationViolation(Exception):
    pass


class GuestTable:
    """Per-WorkUnit guest routing table (the Kata guest IPtable analogue)."""

    def __init__(self, unit_uid: str):
        self.unit_uid = unit_uid
        self.rules: Dict[str, List[str]] = {}   # virtual_ip -> endpoints
        self.injected_at: Dict[str, float] = {}
        self._lock = threading.Lock()

    def apply(self, vip: str, endpoints: List[str]) -> bool:
        with self._lock:
            changed = self.rules.get(vip) != endpoints
            if changed:
                self.rules[vip] = list(endpoints)
                self.injected_at[vip] = time.time()
            return changed

    def remove(self, vip: str) -> None:
        with self._lock:
            self.rules.pop(vip, None)
            self.injected_at.pop(vip, None)

    def lookup(self, vip: str) -> List[str]:
        with self._lock:
            return list(self.rules.get(vip, []))

    def __len__(self) -> int:
        with self._lock:
            return len(self.rules)


class MeshRouter(Controller):
    def __init__(self, super_api: APIServer, *, grpc_latency_ms: float = 0.0,
                 scan_interval: float = 60.0, workers: int = 2):
        super().__init__("router", queue=WorkQueue("router"), workers=workers,
                         scan_interval=scan_interval, retry_on=())
        self.super_api = super_api
        self.grpc_latency_ms = grpc_latency_ms   # modelled secure-channel cost
        self.svc_informer = self.add_informer(super_api, "Service",
                                              handler=self._on_service,
                                              name="router/svc")
        self.unit_informer = self.add_informer(super_api, "WorkUnit",
                                               handler=self._on_unit,
                                               name="router/unit")
        self._tables: Dict[str, GuestTable] = {}     # unit uid -> table
        self._unit_ns: Dict[str, str] = {}           # unit uid -> namespace
        self._gates: Dict[str, threading.Event] = {}
        self._lock = threading.Lock()
        self.rules_injected = 0
        self.scan_duration_sum = 0.0
        self.scan_runs = 0

    # -- event plumbing -------------------------------------------------------------

    def _on_unit(self, ev_type: str, unit: Any) -> None:
        uid = unit.metadata.uid
        if ev_type == DELETED:
            with self._lock:
                self._tables.pop(uid, None)
                self._unit_ns.pop(uid, None)
                gate = self._gates.pop(uid, None)
            if gate:
                gate.set()
            return
        with self._lock:
            if uid not in self._tables:
                self._tables[uid] = GuestTable(uid)
                self._unit_ns[uid] = unit.metadata.namespace
                self._gates.setdefault(uid, threading.Event())
        self.queue.add((uid, unit.metadata.namespace))

    def _on_service(self, ev_type: str, svc: Any) -> None:
        ns = svc.metadata.namespace
        with self._lock:
            uids = [u for u, n in self._unit_ns.items() if n == ns]
        for uid in uids:
            if ev_type == DELETED:
                with self._lock:
                    table = self._tables.get(uid)
                if table is not None:
                    table.remove(svc.virtual_ip)
            else:
                self.queue.add((uid, ns))

    # -- reconcile ------------------------------------------------------------------

    def reconcile(self, item: Any) -> None:
        uid, ns = item
        self._sync_unit_rules(uid, ns)

    def _sync_unit_rules(self, uid: str, ns: str) -> None:
        """Inject all of the namespace's service rules into one guest table."""
        with self._lock:
            table = self._tables.get(uid)
            gate = self._gates.get(uid)
        if table is None:
            return
        for svc in self.svc_informer.cache.list(ns):
            if not svc.virtual_ip:
                continue
            if table.apply(svc.virtual_ip, svc.endpoints):
                if self.grpc_latency_ms > 0:
                    # vclint: disable=VCL002 simulated gRPC latency, as baselined for repro.core
                    time.sleep(self.grpc_latency_ms / 1e3)
                with self._lock:
                    self.rules_injected += 1
        if gate is not None:
            gate.set()   # rules current: release the init gate

    # -- init-container handshake -----------------------------------------------------

    def wait_for_rules(self, unit_uid: str, timeout: float = 30.0) -> bool:
        with self._lock:
            gate = self._gates.setdefault(unit_uid, threading.Event())
        return gate.wait(timeout)

    def table(self, unit_uid: str) -> Optional[GuestTable]:
        with self._lock:
            return self._tables.get(unit_uid)

    # -- periodic reconcile scan (paper §IV-E) -------------------------------------------

    def scan(self) -> int:
        t0 = time.monotonic()
        checked = 0
        with self._lock:
            uids = list(self._unit_ns.items())
        for uid, ns in uids:
            self._sync_unit_rules(uid, ns)
            checked += 1
        self.scan_runs += 1
        self.scan_duration_sum += time.monotonic() - t0
        return checked

    # -- collective isolation validation ---------------------------------------------------

    _COLLECTIVE_RE = re.compile(
        r"\b(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
        r"[^\n]*?replica_groups=(\{\{[^}]*(?:\},\{[^}]*)*\}\}|\[[^\]]*\][^ ]*)")
    _PERMUTE_PAIRS_RE = re.compile(
        r"collective-permute[^\n]*?source_target_pairs=\{([^}]*)\}")

    @classmethod
    def collective_groups(cls, hlo_text: str) -> List[Set[int]]:
        """Extract every collective's participating device set from HLO text."""
        groups: List[Set[int]] = []
        for m in cls._COLLECTIVE_RE.finditer(hlo_text):
            body = m.group(2)
            if body.startswith("{{"):
                for grp in re.findall(r"\{([0-9, ]*)\}", body[1:-1]):
                    ids = {int(x) for x in grp.replace(" ", "").split(",") if x}
                    if ids:
                        groups.append(ids)
            else:
                # iota-style v2 replica groups: [N,M]<=[...] — covers all devices
                dims = re.match(r"\[(\d+),(\d+)\]", body)
                if dims:
                    n, mdim = int(dims.group(1)), int(dims.group(2))
                    groups.append(set(range(n * mdim)))
        for m in cls._PERMUTE_PAIRS_RE.finditer(hlo_text):
            ids = {int(x) for x in re.findall(r"\d+", m.group(1))}
            if ids:
                groups.append(ids)
        return groups

    @classmethod
    def validate_isolation(cls, hlo_text: str, slice_devices: Sequence[int],
                           device_order: Optional[Sequence[int]] = None
                           ) -> int:
        """Assert no collective escapes ``slice_devices``. Returns #collectives.

        The TPU-native "VPC" guarantee: a tenant program compiled for its
        slice must not communicate outside it. Replica groups in compiled
        HLO use LOGICAL ids (0..n-1 in the program's device assignment);
        pass ``device_order`` (logical index -> physical device id, e.g.
        ``[d.id for d in mesh.devices.flatten()]``) to validate against
        physical slice membership.
        """
        allowed = set(slice_devices)
        groups = cls.collective_groups(hlo_text)
        for g in groups:
            if device_order is not None:
                g = {device_order[i] for i in g if i < len(device_order)}
            if not g <= allowed:
                raise IsolationViolation(
                    f"collective spans devices {sorted(g - allowed)[:8]} "
                    f"outside the tenant slice")
        return len(groups)
