"""Per-control-plane API server.

Each tenant control plane and the super cluster own one APIServer wrapping a
dedicated ObjectStore (paper: "a dedicated etcd can be assigned to each tenant
control plane"). It adds:
- token-bucket request rate limiting (k8s built-in client rate limits);
- request metrics (the Fig.1 interference story becomes measurable);
- a bearer credential whose hash identifies the tenant (used by VnAgent);
- per-client handles (:meth:`APIServer.client`): thin views over the shared
  store, each with a dedicated token bucket, so independent callers (e.g.
  syncer shards) don't serialize on one bucket lock.
"""
from __future__ import annotations

import hashlib
import threading
import time
from typing import Any, Callable, List, Optional, Tuple

from . import trace as trace_mod
from .executor import RetryLater, current_thread_pooled
from .objects import new_uid
from .store import ContinueToken, ObjectStore


class RateLimited(RetryLater):
    """Token bucket exhausted. Subclasses :class:`RetryLater`, so any
    controller already retrying RetryLater backs off instead of crashing
    when a burst empties its client's bucket on a pool thread."""


class TokenBucket:
    """qps/burst token bucket (client-go flowcontrol analogue)."""

    def __init__(self, qps: float = 10_000.0, burst: int = 20_000):
        self.qps = float(qps)
        self.burst = float(burst)
        self._tokens = float(burst)
        self._last = time.monotonic()
        self._lock = threading.Lock()

    def take(self, block: bool = True, n: int = 1) -> None:
        n = min(n, self.burst)   # a batch above burst capacity must not hang
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(self.burst, self._tokens + (now - self._last) * self.qps)
                self._last = now
                if self._tokens >= n:
                    self._tokens -= n
                    return
                need = (n - self._tokens) / self.qps
            if not block or current_thread_pooled():
                # a cooperative pool thread must NEVER park here: stalling
                # one quantum stalls every task behind it. Raise instead —
                # RateLimited is a RetryLater, so reconcile loops requeue
                # the key with backoff and the pool keeps draining.
                raise RateLimited(
                    f"bucket empty for {need * 1e3:.1f}ms (qps={self.qps})")
            time.sleep(need)   # vclint: disable=VCL002 pool threads raise above


class APIClient:
    """Rate-limited CRUD/list/watch handle over a (possibly shared) ObjectStore.

    Every client has its OWN token bucket and request counters; many clients
    may front one store (the k8s picture: many connections, one apiserver
    storage). :class:`APIServer` is itself the default client that owns the
    store; extra handles come from :meth:`APIServer.client`.
    """

    def __init__(self, name: str, store: ObjectStore,
                 qps: float = 50_000.0, burst: int = 100_000):
        self.name = name
        self.store = store
        self.qps = qps
        self.burst = burst
        self._bucket = TokenBucket(qps, burst)
        self._lock = threading.Lock()
        self.request_count = 0
        self.request_latency_sum = 0.0
        # Optional per-tenant accountability hooks (attached by the
        # framework / AuditLog.attach). All three default to "off"; an
        # unwired client pays two attribute loads per request and is
        # otherwise the pre-audit code path.
        self.audit: Optional[Any] = None
        self.meter: Optional[Any] = None
        self.obs_tenant = ""

    def _req(self, fn: Callable[[], Any], tokens: int = 1, verb: str = "",
             kind: str = "", namespace: str = "", name: str = "",
             obj: Any = None) -> Any:
        if self.audit is None and self.meter is None:
            t0 = time.monotonic()
            self._bucket.take(n=tokens)
            out = fn()
            with self._lock:
                self.request_count += 1
                self.request_latency_sum += time.monotonic() - t0
            return out
        return self._req_observed(fn, tokens, verb, kind, namespace, name,
                                  obj)

    def _req_observed(self, fn: Callable[[], Any], tokens: int, verb: str,
                      kind: str, namespace: str, name: str, obj: Any) -> Any:
        t0 = time.monotonic()
        try:
            self._bucket.take(n=tokens)
            out = fn()
        except Exception as e:
            # failures are audited but (as before) do not bump the
            # request counters — the request never completed
            self._observe(verb, kind, namespace, name, obj,
                          type(e).__name__, time.monotonic() - t0, tokens)
            raise
        dt = time.monotonic() - t0
        with self._lock:
            self.request_count += 1
            self.request_latency_sum += dt
        self._observe(verb, kind, namespace, name, obj, "ok", dt, tokens)
        return out

    def _observe(self, verb: str, kind: str, namespace: str, name: str,
                 obj: Any, outcome: str, latency_s: float,
                 count: int) -> None:
        """Extract ONLY scalars from the subject — ``obj`` may be a
        ``copy=False`` store internal; retaining it (or any of its mutable
        containers) past this hook would alias live store state."""
        tenant = self.obs_tenant or self.name
        if obj is not None:
            if not kind:
                kind = getattr(type(obj), "kind", "")
            md = obj.metadata
            namespace = md.namespace
            name = md.name
        meter = self.meter
        if meter is not None:
            meter.add(tenant, "api_requests", float(count))
        audit = self.audit
        if audit is not None:
            tp: Optional[str] = None
            if obj is not None:
                tp = obj.metadata.annotations.get(trace_mod.TRACEPARENT_KEY)
                if tp is not None and not trace_mod.sampled_carrier(tp):
                    tp = None
            audit.record(tenant, verb, kind, namespace, name, outcome,
                         latency_s, count=count, traceparent=tp)

    # -- API surface ---------------------------------------------------------

    def create(self, obj: Any) -> Any:
        return self._req(lambda: self.store.create(obj),
                         verb="create", obj=obj)

    def create_batch(self, objs: List[Any]) -> Tuple[List[Any], List[Any]]:
        """Batched create: one request, ``len(objs)`` rate-limit tokens.
        Returns ``(created, conflicted)`` (see ``ObjectStore.create_many``)."""
        return self._req(lambda: self.store.create_many(objs),
                         tokens=max(1, len(objs)), verb="create_batch",
                         obj=objs[0] if objs else None)

    def get(self, kind: str, namespace: str, name: str) -> Any:
        return self._req(lambda: self.store.get(kind, namespace, name),
                         verb="get", kind=kind, namespace=namespace,
                         name=name)

    def update(self, obj: Any, *, force: bool = False) -> Any:
        return self._req(lambda: self.store.update(obj, force=force),
                         verb="update", obj=obj)

    def update_batch(self, objs: List[Any], *, force: bool = False
                     ) -> Tuple[List[Any], List[Any]]:
        """Batched update: one request, ``len(objs)`` rate-limit tokens.
        Returns ``(updated, conflicted)`` (see ``ObjectStore.update_many``)."""
        return self._req(lambda: self.store.update_many(objs, force=force),
                         tokens=max(1, len(objs)), verb="update_batch",
                         obj=objs[0] if objs else None)

    def update_status(self, kind: str, namespace: str, name: str,
                      mutate: Callable[[Any], None]) -> Any:
        return self._req(lambda: self.store.update_status(kind, namespace, name, mutate),
                         verb="update_status", kind=kind,
                         namespace=namespace, name=name)

    def update_status_batch(self, updates: List[Tuple[str, str, str,
                                                      Callable[[Any], None]]]
                            ) -> Tuple[List[Any], List[Tuple[str, str, str]]]:
        """Batched status RMW: one request, ``len(updates)`` rate-limit
        tokens. Returns ``(updated, missing)`` (see
        ``ObjectStore.update_status_many``)."""
        return self._req(lambda: self.store.update_status_many(updates),
                         tokens=max(1, len(updates)),
                         verb="update_status_batch",
                         kind=updates[0][0] if updates else "",
                         namespace=updates[0][1] if updates else "")

    def delete(self, kind: str, namespace: str, name: str) -> Any:
        return self._req(lambda: self.store.delete(kind, namespace, name),
                         verb="delete", kind=kind, namespace=namespace,
                         name=name)

    def delete_batch(self, keys: List[Tuple[str, str, str]]
                     ) -> Tuple[List[Any], List[Tuple[str, str, str]]]:
        """Batched delete: one request, ``len(keys)`` rate-limit tokens.
        Returns ``(deleted, missing)`` (see ``ObjectStore.delete_many``)."""
        return self._req(lambda: self.store.delete_many(keys),
                         tokens=max(1, len(keys)), verb="delete_batch",
                         kind=keys[0][0] if keys else "",
                         namespace=keys[0][1] if keys else "")

    def list(self, kind: str, namespace: Optional[str] = None, *,
             copy: bool = True) -> List[Any]:
        """Snapshot LIST. ``copy=False`` returns the stored refs (READ-ONLY
        contract) for trusted in-process consumers — zero deepcopy cost."""
        return self._req(lambda: self.store.list(kind, namespace, copy=copy),
                         verb="list", kind=kind, namespace=namespace or "")

    def list_paged(self, kind: str, namespace: Optional[str] = None, *,
                   limit: int = 500,
                   continue_token: Optional[ContinueToken] = None,
                   copy: bool = True
                   ) -> Tuple[List[Any], Optional[ContinueToken], int]:
        """One page of a k8s-style paged LIST: ``(page, continue_token, rv)``.
        Pass the returned token back to fetch the next page (None = done);
        all pages are consistent at ``rv``. Each page costs one rate-limit
        token — a cold 100k-object LIST no longer starves the bucket."""
        return self._req(lambda: self.store.list_page(
            kind, namespace, limit=limit, continue_token=continue_token,
            copy=copy), verb="list", kind=kind, namespace=namespace or "")

    def list_all_pages(self, kind: str, namespace: Optional[str] = None, *,
                       limit: int = 500, copy: bool = True
                       ) -> Tuple[List[Any], int]:
        """Drain every page of a paged LIST: ``(objects, rv)``. The rv is
        the snapshot version — resume a watch from it to catch up."""
        out: List[Any] = []
        token: Optional[ContinueToken] = None
        while True:
            page, token, rv = self.list_paged(
                kind, namespace, limit=limit, continue_token=token, copy=copy)
            out.extend(page)
            if token is None:
                return out, rv

    def watch(self, kind: str, namespace: Optional[str] = None, *,
              from_rv: Optional[int] = None, copy: bool = True,
              buffer: int = 100_000):
        """Open a watch; ``from_rv`` resumes from a resourceVersion (raises
        ``ResourceVersionExpired`` when the backlog no longer covers it),
        ``copy=False`` streams shared READ-ONLY refs (zero-copy events),
        ``buffer`` bounds the channel (overflow closes the stream)."""
        return self.store.watch(kind, namespace, from_rv=from_rv, copy=copy,
                                buffer=buffer)

    def list_and_watch(self, kind: str, namespace: Optional[str] = None, *,
                       copy: bool = True):
        return self._req(lambda: self.store.list_and_watch(kind, namespace,
                                                           copy=copy),
                         verb="list_and_watch", kind=kind,
                         namespace=namespace or "")


class APIServer(APIClient):
    """The store-owning client plus server-side identity and lifecycle."""

    def __init__(self, name: str, qps: float = 50_000.0, burst: int = 100_000):
        super().__init__(name, ObjectStore(name), qps, burst)
        self.credential = new_uid()          # bearer token for this plane

    @property
    def credential_hash(self) -> str:
        return hashlib.sha256(self.credential.encode()).hexdigest()[:16]

    def client(self, name: str, qps: Optional[float] = None,
               burst: Optional[int] = None) -> APIClient:
        """A dedicated client handle: same store, its own token bucket.
        Inherits the server's audit/meter attribution, so per-shard handles
        over a tenant plane keep accounting to that tenant."""
        c = APIClient(f"{self.name}/{name}", self.store,
                      qps if qps is not None else self.qps,
                      burst if burst is not None else self.burst)
        c.audit = self.audit
        c.meter = self.meter
        c.obs_tenant = self.obs_tenant
        return c

    def close(self) -> None:
        self.store.close()


class TenantControlPlane:
    """A dedicated tenant control plane (apiserver + store, no scheduler).

    Paper §III-B: "a tenant control plane does not need a scheduler since the
    Pod scheduling is done in the super cluster."
    """

    def __init__(self, name: str, weight: int = 1):
        self.name = name
        self.weight = weight
        self.api = APIServer(f"tenant:{name}")
        # fixed attribution labels: a tenant plane is single-tenant by
        # construction, so audit/meter hooks attached later need no lookup
        self.api.obs_tenant = name
        self.api.store.meter_tenant = name

    def kubeconfig(self) -> dict:
        """Access credential stored in the super cluster by the operator."""
        return {"tenant": self.name, "credential": self.api.credential}

    def close(self) -> None:
        self.api.close()
