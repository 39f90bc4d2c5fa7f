"""Typed API objects for the VirtualCluster control plane.

These mirror the Kubernetes object model the paper builds on: every object has
ObjectMeta (name/namespace/uid/resourceVersion/creationTimestamp) and a
kind-specific spec/status. Objects are plain dataclasses; the store assigns
uid + resourceVersion and owns copy semantics (etcd-like).
"""
from __future__ import annotations

import dataclasses
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


def new_uid() -> str:
    return uuid.uuid4().hex


@dataclass
class ObjectMeta:
    name: str
    namespace: str = ""                  # "" => cluster-scoped
    uid: str = ""
    resource_version: int = 0
    creation_timestamp: float = 0.0      # time.time() at create
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    deletion_timestamp: Optional[float] = None

    @property
    def key(self) -> str:
        """namespace/name full key (k8s convention)."""
        return f"{self.namespace}/{self.name}" if self.namespace else self.name


@dataclass
class Condition:
    type: str                            # e.g. "Ready", "PodScheduled"
    status: str                          # "True" | "False" | "Unknown"
    last_transition_time: float = 0.0
    reason: str = ""


# --------------------------------------------------------------------------
# Cluster-scoped objects
# --------------------------------------------------------------------------

@dataclass
class Namespace:
    kind = "Namespace"
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(""))
    phase: str = "Active"


@dataclass
class NodeStatus:
    capacity_chips: int = 8              # one TPU host = 8 chips
    allocatable_chips: int = 8
    phase: str = "Ready"                 # Ready | NotReady
    heartbeat_time: float = 0.0
    heartbeat_latency_ms: float = 0.0    # straggler signal


@dataclass
class Node:
    """A physical TPU host in the super cluster."""
    kind = "Node"
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(""))
    status: NodeStatus = field(default_factory=NodeStatus)
    # global chip ids owned by this host (for mesh-slice carving)
    chip_ids: List[int] = field(default_factory=list)


@dataclass
class VirtualNode:
    """Tenant-visible 1:1 image of a physical Node (the paper's vNode)."""
    kind = "VirtualNode"
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(""))
    physical_node: str = ""
    status: NodeStatus = field(default_factory=NodeStatus)


@dataclass
class VirtualClusterCR:
    """The VC CRD: describes one tenant control plane (paper Fig.4 (1))."""
    kind = "VirtualClusterCR"
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(""))
    apiserver_version: str = "1.18"
    mode: str = "local"                  # local | cloud
    weight: int = 1                      # WRR fair-queuing weight
    phase: str = "Pending"               # Pending | Running | Terminating
    kubeconfig_secret: str = ""          # secret name in super holding the credential


# --------------------------------------------------------------------------
# Namespace-scoped objects
# --------------------------------------------------------------------------

@dataclass
class WorkUnitSpec:
    """Pod analogue: a schedulable ML work bundle."""
    arch: str = "tiny-dense"             # architecture config id
    shape: str = "train_4k"              # input-shape id
    chips: int = 1                       # slice request
    node_selector: Dict[str, str] = field(default_factory=dict)
    # inter-WorkUnit anti-affinity: labels that must not co-locate on a node
    anti_affinity: List[str] = field(default_factory=list)
    init_gate: bool = False              # require router rules before Ready
    payload: Dict[str, Any] = field(default_factory=dict)


@dataclass
class WorkUnitStatus:
    phase: str = "Pending"               # Pending|Scheduled|Running|Ready|Failed
    node: str = ""                       # bound physical node (super) / vnode (tenant)
    conditions: List[Condition] = field(default_factory=list)
    restart_count: int = 0
    message: str = ""

    def condition(self, ctype: str) -> Optional[Condition]:
        for c in self.conditions:
            if c.type == ctype:
                return c
        return None

    def set_condition(self, ctype: str, status: str, reason: str = "") -> None:
        now = time.time()
        c = self.condition(ctype)
        if c is None:
            self.conditions.append(
                Condition(type=ctype, status=status,
                          last_transition_time=now, reason=reason))
        elif c.status != status:
            c.status, c.last_transition_time, c.reason = status, now, reason


@dataclass
class WorkUnit:
    kind = "WorkUnit"
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(""))
    spec: WorkUnitSpec = field(default_factory=WorkUnitSpec)
    status: WorkUnitStatus = field(default_factory=WorkUnitStatus)


@dataclass
class Service:
    """cluster-IP-type service: virtual address routed to endpoints."""
    kind = "Service"
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(""))
    selector: Dict[str, str] = field(default_factory=dict)
    virtual_ip: str = ""
    ports: List[int] = field(default_factory=lambda: [8471])
    endpoints: List[str] = field(default_factory=list)


@dataclass
class Event:
    """Kubernetes-style Event with count/lastTimestamp compression.

    Repeated occurrences of the same (involved object, reason, component)
    tuple are folded into ONE object whose ``count`` increments and whose
    ``last_timestamp`` advances (kubelet event-aggregation semantics), so a
    heartbeat or a flapping WorkUnit costs one stored object, not one per
    occurrence. Recorded by :class:`~repro_torch.core.upward.EventRecorder`;
    synced upward so tenants can list their own events.
    """
    kind = "Event"
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(""))
    involved_kind: str = ""
    involved_namespace: str = ""
    involved_name: str = ""
    reason: str = ""
    message: str = ""
    type: str = "Normal"                 # Normal | Warning
    source_component: str = ""
    source_host: str = ""
    count: int = 1
    first_timestamp: float = 0.0
    last_timestamp: float = 0.0


@dataclass
class Secret:
    kind = "Secret"
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(""))
    data: Dict[str, str] = field(default_factory=dict)


@dataclass
class ConfigMap:
    kind = "ConfigMap"
    metadata: ObjectMeta = field(default_factory=lambda: ObjectMeta(""))
    data: Dict[str, str] = field(default_factory=dict)


# All kinds the framework knows about; the syncer synchronizes a subset.
KINDS = {
    "Namespace": Namespace,
    "Node": Node,
    "VirtualNode": VirtualNode,
    "VirtualClusterCR": VirtualClusterCR,
    "WorkUnit": WorkUnit,
    "Service": Service,
    "Secret": Secret,
    "ConfigMap": ConfigMap,
    "Event": Event,
}

# Paper §III-C: the syncer populates only resources used in Pod provision.
SYNCED_KINDS_DOWNWARD = ["Namespace", "Secret", "ConfigMap", "WorkUnit", "Service"]
# Upward: super status (and Events) projected back into tenant planes.
SYNCED_KINDS_UPWARD = ["WorkUnit", "Service", "Event"]


def obj_kind(obj: Any) -> str:
    return type(obj).kind


def obj_key(obj: Any) -> Tuple[str, str, str]:
    """(kind, namespace, name) — the store's primary key."""
    return (obj_kind(obj), obj.metadata.namespace, obj.metadata.name)


# top-level deepcopy_obj invocations (one per object copied, not per node of
# the dataclass tree) — the benchmark's per-phase copy accounting; a plain
# int mutated under the GIL is accurate enough for coarse phase deltas
DEEPCOPY_COUNT = 0


def deepcopy_count() -> int:
    return DEEPCOPY_COUNT


def _copy(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        # REPRO_SANITIZE=1 hands out frozen proxy subclasses; copying one
        # must thaw back to the real class (proxies forbid __init__'s
        # setattr, and a copy is by definition mutable again)
        cls = getattr(type(obj), "__frozen_base__", type(obj))
        return cls(**{
            f.name: _copy(getattr(obj, f.name))
            for f in dataclasses.fields(obj)
        })
    if isinstance(obj, dict):
        return {k: _copy(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_copy(v) for v in obj]
    return obj


def deepcopy_obj(obj: Any) -> Any:
    """Fast structural copy of an API object (dataclass tree)."""
    global DEEPCOPY_COUNT
    DEEPCOPY_COUNT += 1
    return _copy(obj)


def spec_equal(a: Any, b: Any) -> bool:
    """Two-side desired-state comparison (downward sync / scan)."""
    if obj_kind(a) != obj_kind(b):
        return False
    if hasattr(a, "spec"):
        return a.spec == b.spec
    if hasattr(a, "data"):
        return a.data == b.data
    if obj_kind(a) == "Service":
        return a.selector == b.selector and a.ports == b.ports
    return True


def status_equal(a: Any, b: Any, ignore_node: bool = False) -> bool:
    """WorkUnit status comparison (upward sync / scan)."""
    if ignore_node:
        a, b = deepcopy_obj(a), deepcopy_obj(b)
        a.node = b.node = ""
    return (a.phase == b.phase and a.node == b.node
            and {c.type: c.status for c in a.conditions}
            == {c.type: c.status for c in b.conditions})
