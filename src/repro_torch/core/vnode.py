"""Virtual node management (paper §III-C, Fig.6).

Each VirtualNode in a tenant control plane is a 1:1 image of a physical Node
in the super cluster — preserving node semantics (anti-affinity, topology)
unlike virtual-kubelet's single aggregate node. The syncer:
- creates a vNode in the tenant plane when a tenant WorkUnit binds to a
  physical node;
- broadcasts physical node heartbeats to all tenant vNodes;
- tracks WorkUnit<->vNode bindings and garbage-collects vNodes with none;
- records tenant-visible Events on vNode appearance/GC (the tenant-side
  half of the event story — these never need upward sync since they are
  written straight into the tenant plane).
"""
from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Dict, Set, Tuple

from .objects import Node, VirtualNode, deepcopy_obj
from .store import AlreadyExistsError, NotFoundError
from .upward import EventRecorder

if TYPE_CHECKING:
    from .apiserver import TenantControlPlane


class VNodeManager:
    def __init__(self, record_events: bool = True):
        self._lock = threading.Lock()
        # (tenant, vnode_name) -> set of (namespace, unit_name) bindings
        self._bindings: Dict[Tuple[str, str], Set[Tuple[str, str]]] = {}
        self.record_events = record_events
        self.gc_count = 0
        self.heartbeats_broadcast = 0

    def _record(self, plane: "TenantControlPlane", vname: str, reason: str,
                message: str) -> None:
        if not self.record_events:
            return
        EventRecorder(plane.api, "vnode-manager").record(
            "VirtualNode", "", vname, reason, message)

    def bind(self, tenant_plane: "TenantControlPlane", node: Node,
             unit_ns: str, unit_name: str) -> str:
        """Ensure vNode exists in the tenant plane; record the binding."""
        tenant = tenant_plane.name
        vname = node.metadata.name            # 1:1: same name as physical node
        with self._lock:
            key = (tenant, vname)
            fresh = key not in self._bindings
            self._bindings.setdefault(key, set()).add((unit_ns, unit_name))
        if fresh:
            vn = VirtualNode()
            vn.metadata.name = vname
            vn.physical_node = node.metadata.name
            # deep copy: ``node`` may be a zero-copy informer-cache ref, and
            # the vNode must not alias the super cluster's NodeStatus
            vn.status = deepcopy_obj(node.status)
            try:
                tenant_plane.api.create(vn)
            except AlreadyExistsError:
                pass
            self._record(tenant_plane, vname, "VNodeBound",
                         f"vNode {vname} appeared for {unit_ns}/{unit_name}")
        return vname

    def unbind(self, tenant_plane: "TenantControlPlane", unit_ns: str,
               unit_name: str) -> None:
        """Drop any binding held by (unit_ns, unit_name); GC empty vNodes."""
        tenant = tenant_plane.name
        to_gc = []
        with self._lock:
            for (t, vname), units in list(self._bindings.items()):
                if t != tenant:
                    continue
                units.discard((unit_ns, unit_name))
                if not units:
                    del self._bindings[(t, vname)]
                    to_gc.append(vname)
        for vname in to_gc:
            try:
                tenant_plane.api.delete("VirtualNode", "", vname)
                self.gc_count += 1
            except NotFoundError:
                pass
            self._record(tenant_plane, vname, "VNodeGC",
                         f"vNode {vname} released (no bound WorkUnits)")

    def broadcast_heartbeat(self, tenants: Dict[str, "TenantControlPlane"],
                            node: Node) -> None:
        """Paper: "physical node heartbeats will be broadcasted to all virtual
        nodes periodically"."""
        with self._lock:
            targets = [t for (t, vname) in self._bindings
                       if vname == node.metadata.name]
        for tenant in targets:
            plane = tenants.get(tenant)
            if plane is None:
                continue
            try:
                plane.api.update_status(
                    "VirtualNode", "", node.metadata.name,
                    lambda vn: setattr(vn, "status",
                                       deepcopy_obj(node.status)))
                self.heartbeats_broadcast += 1
            except NotFoundError:
                pass

    def bound_vnodes(self, tenant: str) -> Set[str]:
        with self._lock:
            return {v for (t, v) in self._bindings if t == tenant}
