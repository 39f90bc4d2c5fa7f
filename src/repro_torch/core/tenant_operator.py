"""Tenant operator (paper Fig.4 (1)).

Watches VirtualClusterCR (VC) objects in the super cluster and reconciles
tenant-control-plane lifecycle: provision a dedicated apiserver+store per
tenant ("local mode"), store its kubeconfig as a Secret in the super cluster
so the syncer can reach every tenant plane, register the tenant with the
syncer and the vn-agents, and tear everything down on delete.

Runs on the shared controller runtime: one informer, a delaying queue, one
worker, rate-limited retries on provisioning errors. Under the cooperative
executor all of it is pool tasks (tenant registration spawns the per-tenant
informer pumps on the same shared pool).
"""
from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional

from .agent import VnAgent
from .apiserver import APIServer, TenantControlPlane
from .objects import Secret, VirtualClusterCR
from .runtime import Controller
from .store import DELETED, AlreadyExistsError, NotFoundError
from .syncer import Syncer
from .workqueue import DelayingQueue


OPERATOR_NS = "vc-system"


class TenantOperator(Controller):
    def __init__(self, super_api: APIServer, syncer: Syncer,
                 vn_agents: Optional[List[VnAgent]] = None):
        super().__init__("tenant-operator",
                         queue=DelayingQueue("tenant-operator"), workers=1,
                         retry_on=(Exception,))
        self.super_api = super_api
        self.syncer = syncer
        self.vn_agents = vn_agents or []
        self.informer = self.add_informer(super_api, "VirtualClusterCR",
                                          handler=self._on_vc,
                                          name="operator/vc")
        self.planes: Dict[str, TenantControlPlane] = {}
        self._lock = threading.Lock()
        # optional accountability hooks (framework-set): applied to every
        # plane at provisioning, BEFORE syncer registration, so informer
        # pumps and sync lanes are attributed from the first request
        self.audit: Optional[Any] = None
        self.meter: Optional[Any] = None

    def _on_vc(self, ev_type: str, vc: VirtualClusterCR) -> None:
        self.queue.add((ev_type == DELETED, vc.metadata.name))

    def reconcile(self, item: Any) -> None:
        deleted, name = item
        if deleted:
            self._teardown(name)
        else:
            self._reconcile_vc(name)

    def _reconcile_vc(self, name: str) -> None:
        vc = self.informer.cache.get("", name)
        if vc is None:
            self._teardown(name)
            return
        with self._lock:
            if name in self.planes:
                return
            plane = TenantControlPlane(name, weight=vc.weight)
            if self.audit is not None:
                plane.api.audit = self.audit
            if self.meter is not None:
                plane.api.meter = self.meter
                plane.api.store.meter = self.meter
            self.planes[name] = plane
        # persist the kubeconfig in the super cluster (paper: "stores the
        # kubeconfig ... so that the syncer controller can access all tenant
        # control planes")
        sec = Secret()
        sec.metadata.name = f"kubeconfig-{name}"
        sec.metadata.namespace = OPERATOR_NS
        sec.data = {k: str(v) for k, v in plane.kubeconfig().items()}
        try:
            self.super_api.create(sec)
        except AlreadyExistsError:
            pass
        prefix = self.syncer.register_tenant(plane, vc.metadata.uid)
        for agent in self.vn_agents:
            agent.register_tenant(plane.api.credential, prefix)
        self.super_api.update_status(
            "VirtualClusterCR", "", name,
            lambda v: setattr(v, "phase", "Running"))

    def _teardown(self, name: str) -> None:
        with self._lock:
            plane = self.planes.pop(name, None)
        if plane is None:
            return
        self.syncer.unregister_tenant(name)
        try:
            self.super_api.delete("Secret", OPERATOR_NS, f"kubeconfig-{name}")
        except NotFoundError:
            pass
        plane.close()
