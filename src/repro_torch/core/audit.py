"""k8s-style per-tenant audit trail for the API surface.

Every tenant-attributed API operation funnels through ``APIClient._req``;
when an :class:`AuditLog` is attached to the client, each operation lands as
one audit record — verb, kind, namespace, name, outcome (``"ok"`` or the
exception class name), latency, batch size, and the subject's traceparent
when the carrying trace was sampled — in a bounded per-tenant ring. Exact
per-(tenant, verb) counters ride alongside the rings so accounting stays
precise even after ring eviction.

Zero-cost-when-off contract (same as the tracer): an unattached client pays
one attribute load + identity test per request and is otherwise byte-for-byte
the pre-audit code path. When attached, records are plain dicts built
*outside* the audit lock; only the ring append and counter bump run under it.
``records()`` copies under the lock, so scrapes of ``/audit`` never tear a
record and never block writers for more than a shallow list copy.

Audit records deliberately hold **only scalars** extracted from the subject
object (names, sizes, the traceparent string) — never the object itself or
any of its mutable containers. Objects flowing past the hook may be
``copy=False`` store internals; retaining them would alias live store state
(vclint VCL007 enforces this at the AST level).
"""
from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

#: Default per-tenant ring capacity. Sized like the tracer ring: bounded so
#: an abusive tenant can evict only its *own* history, never a neighbor's.
DEFAULT_RING_CAPACITY = 2048

_seq = itertools.count(1)


class AuditLog:
    """Bounded per-tenant audit rings + exact per-(tenant, verb) counters."""

    def __init__(self, *, per_tenant_capacity: int = DEFAULT_RING_CAPACITY):
        self.capacity = max(1, int(per_tenant_capacity))
        self._lock = threading.Lock()
        self._rings: Dict[str, Deque[Dict[str, Any]]] = {}
        self._counts: Dict[Tuple[str, str], int] = {}
        self.recorded = 0

    def attach(self, client: Any, tenant: str) -> None:
        """Wire an :class:`~repro_torch.core.apiserver.APIClient` (or APIServer)
        to this log under a tenant attribution label."""
        client.obs_tenant = tenant
        client.audit = self

    # ------------------------------------------------------------- writes
    def record(self, tenant: str, verb: str, kind: str, namespace: str,
               name: str, outcome: str, latency_s: float, count: int = 1,
               traceparent: Optional[str] = None) -> None:
        rec: Dict[str, Any] = {          # built outside the lock
            "seq": next(_seq),
            "ts": time.time(),
            "tenant": tenant,
            "verb": verb,
            "kind": kind,
            "namespace": namespace,
            "name": name,
            "outcome": outcome,
            "latency_s": latency_s,
            "count": count,
        }
        if traceparent is not None:
            rec["traceparent"] = traceparent
        ckey = (tenant, verb)
        with self._lock:
            ring = self._rings.get(tenant)
            if ring is None:
                ring = self._rings[tenant] = deque(maxlen=self.capacity)
            ring.append(rec)
            self._counts[ckey] = self._counts.get(ckey, 0) + count
            self.recorded += 1

    # -------------------------------------------------------------- reads
    def records(self, tenant: Optional[str] = None,
                verb: Optional[str] = None, kind: Optional[str] = None,
                limit: int = 0) -> List[Dict[str, Any]]:
        """Filtered copies of retained records, oldest first. ``limit`` keeps
        the *newest* N after filtering (0 = no limit)."""
        with self._lock:
            if tenant is not None:
                ring = self._rings.get(tenant)
                raw = [dict(r) for r in ring] if ring else []
            else:
                raw = [dict(r) for ring in self._rings.values() for r in ring]
        raw.sort(key=lambda r: r["seq"])
        if verb is not None:
            raw = [r for r in raw if r["verb"] == verb]
        if kind is not None:
            raw = [r for r in raw if r["kind"] == kind]
        if limit > 0:
            raw = raw[-limit:]
        return raw

    def counts(self) -> Dict[str, Dict[str, int]]:
        """Exact lifetime operation counts: ``{tenant: {verb: n}}`` where a
        batch of N contributes N (these never expire with the ring)."""
        with self._lock:
            items = list(self._counts.items())
        out: Dict[str, Dict[str, int]] = {}
        for (tenant, verb), n in items:
            out.setdefault(tenant, {})[verb] = n
        return out

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            retained = sum(len(r) for r in self._rings.values())
            tenants = len(self._rings)
        return {"recorded": self.recorded, "retained": retained,
                "tenants": tenants, "capacity_per_tenant": self.capacity}

    def state(self, tenant: Optional[str] = None, verb: Optional[str] = None,
              kind: Optional[str] = None, limit: int = 256) -> Dict[str, Any]:
        """The ``/audit`` payload (filters map 1:1 to query params)."""
        return {
            "enabled": True,
            "stats": self.stats(),
            "counts": self.counts(),
            "filters": {"tenant": tenant, "verb": verb, "kind": kind,
                        "limit": limit},
            "records": self.records(tenant=tenant, verb=verb, kind=kind,
                                    limit=limit),
        }

    def clear(self) -> None:
        with self._lock:
            self._rings.clear()
            self._counts.clear()
            self.recorded = 0
