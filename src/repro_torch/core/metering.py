"""Per-tenant usage metering + noisy-neighbor attribution.

The :class:`UsageMeter` aggregates tenant consumption on every resource axis
the platform shares — control-plane API requests and object bytes, downward/
upward sync items and batch bandwidth, fair-queue occupancy, and data-plane
slot-seconds/tokens/TTFT — into rolling bucketed windows (same idiom as
:mod:`repro_torch.core.slo`) plus exact lifetime totals. On top of the windows sits
a **dominant-share detector**: for each resource axis the tenant's windowed
share is compared against the fair share ``1/N`` (N = tenants active on that
axis this window) and the tenant's score is the *maximum* ratio across axes —
the classic dominant-resource view of "who is the noisy neighbor". Tenants
scoring above ``noisy_threshold`` are surfaced on ``/usage`` and ``/healthz``
and fed as an advisory dampening input into the autoscaler's WRR weight
autotune, so attribution closes the loop instead of only reporting.

Cost model mirrors the tracer: every hook site guards on a plain attribute
(``meter is not None``) so the disabled path is one load + one identity test;
when enabled, :meth:`UsageMeter.add` is one lock round, a dict probe, and a
float add. Records and snapshots are built outside the meter lock.
"""
from __future__ import annotations

import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, Iterable, List, Optional, Tuple

#: Resource axes that participate in dominant-share scoring. Latency-shaped
#: series (ttft_s, queue_wait_s) are surfaced on /usage but are not
#: consumption, so they are excluded from the detector.
DETECTOR_AXES: Tuple[str, ...] = (
    "api_requests", "object_bytes", "down_items", "down_bytes",
    "up_items", "queue_items", "slot_seconds", "tokens",
)

# rolling window is chopped into this many buckets; expiry granularity is
# window_s / buckets (same scheme as SLOTracker)
_BUCKETS = 30


def obj_nbytes(obj: Any) -> int:
    """Cheap per-object byte estimate for bandwidth accounting — shallow
    instance size plus a flat allowance for metadata/status payloads (the
    same estimator the informer cache uses for its memory gauge)."""
    return sys.getsizeof(obj) + 512


class UsageMeter:
    """Rolling windowed per-tenant consumption series + lifetime totals.

    ``add()`` is the single write entry point (``add_many`` batches several
    axes through one lock round). Reads (``windowed``, ``totals``, ``noisy``,
    ``state``) copy under the lock and aggregate outside it, so scrapes never
    block writers for more than a shallow copy.
    """

    def __init__(self, *, window_s: float = 300.0, buckets: int = _BUCKETS,
                 noisy_threshold: float = 2.0,
                 clock: Callable[[], float] = time.monotonic):
        self.window_s = float(window_s)
        self.buckets = max(2, int(buckets))
        self._width = self.window_s / self.buckets
        self.noisy_threshold = float(noisy_threshold)
        self._clock = clock
        self._lock = threading.Lock()
        # (tenant, resource) -> deque of [bucket_start, qty]
        self._series: Dict[Tuple[str, str], Deque[List[float]]] = {}
        # (tenant, resource) -> lifetime total (exact; never expires)
        self._totals: Dict[Tuple[str, str], float] = {}
        self.adds = 0

    # ------------------------------------------------------------- writes
    def add(self, tenant: str, resource: str, qty: float = 1.0) -> None:
        self.add_many(tenant, ((resource, qty),))

    def add_many(self, tenant: str,
                 pairs: Iterable[Tuple[str, float]]) -> None:
        """Account several resource axes for one tenant in one lock round
        (the batched fast lanes land items+bytes together)."""
        now = self._clock()
        bucket_start = now - (now % self._width)
        horizon = now - self.window_s
        with self._lock:
            self.adds += 1
            for resource, qty in pairs:
                key = (tenant, resource)
                series = self._series.get(key)
                if series is None:
                    series = self._series[key] = deque()
                    self._totals[key] = 0.0
                self._totals[key] += qty
                if series and series[-1][0] == bucket_start:
                    series[-1][1] += qty
                else:
                    series.append([bucket_start, qty])
                    while series and series[0][0] < horizon:
                        series.popleft()

    # -------------------------------------------------------------- reads
    def _copy_series(self) -> List[Tuple[Tuple[str, str], List[List[float]]]]:
        with self._lock:
            return [(k, [list(b) for b in v]) for k, v in self._series.items()]

    def windowed(self, tenant: str, resource: str,
                 now: Optional[float] = None) -> float:
        """Consumption inside the live window (expiry is applied at read
        time too — idle tenants keep stale buckets until their next write)."""
        if now is None:
            now = self._clock()
        horizon = now - self.window_s
        with self._lock:
            series = self._series.get((tenant, resource))
            buckets = [list(b) for b in series] if series else []
        return sum(q for start, q in buckets if start >= horizon)

    def totals(self) -> Dict[str, Dict[str, float]]:
        """Exact lifetime totals: ``{tenant: {resource: qty}}``."""
        with self._lock:
            items = list(self._totals.items())
        out: Dict[str, Dict[str, float]] = {}
        for (tenant, resource), qty in items:
            out.setdefault(tenant, {})[resource] = qty
        return out

    def window_usage(self, now: Optional[float] = None
                     ) -> Dict[str, Dict[str, float]]:
        """Windowed consumption per axis: ``{resource: {tenant: qty}}``."""
        if now is None:
            now = self._clock()
        horizon = now - self.window_s
        out: Dict[str, Dict[str, float]] = {}
        for (tenant, resource), buckets in self._copy_series():
            qty = sum(q for start, q in buckets if start >= horizon)
            if qty > 0.0:
                out.setdefault(resource, {})[tenant] = qty
        return out

    # ----------------------------------------------------------- detector
    def noisy(self, threshold: Optional[float] = None,
              now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Tenants whose dominant share crosses ``threshold``.

        Score per tenant = ``max`` over detector axes of
        ``share / fair_share`` where ``share`` is the tenant's fraction of
        the axis's windowed consumption and ``fair_share = 1/N`` for N
        tenants active on the axis. A lone tenant is its own fair share
        (score 1.0), so single-tenant deployments never alert.
        """
        if threshold is None:
            threshold = self.noisy_threshold
        scores = self.dominant_shares(now=now)
        out = [dict(rec, score=score) for score, rec in scores.values()
               if score >= threshold]
        out.sort(key=lambda r: -r["score"])
        return out

    def dominant_shares(self, now: Optional[float] = None
                        ) -> Dict[str, Tuple[float, Dict[str, Any]]]:
        """``{tenant: (score, {tenant, axis, share, fair_share})}`` — the
        winning axis per tenant with its raw share for explainability."""
        usage = self.window_usage(now=now)
        best: Dict[str, Tuple[float, Dict[str, Any]]] = {}
        for axis in DETECTOR_AXES:
            per_tenant = usage.get(axis)
            if not per_tenant:
                continue
            total = sum(per_tenant.values())
            if total <= 0.0:
                continue
            fair = 1.0 / len(per_tenant)
            for tenant, qty in per_tenant.items():
                share = qty / total
                score = share / fair
                if tenant not in best or score > best[tenant][0]:
                    best[tenant] = (score, {
                        "tenant": tenant, "axis": axis,
                        "share": share, "fair_share": fair,
                    })
        return best

    # ------------------------------------------------------------ surface
    def bind(self, registry: Any) -> None:
        """Register detector gauges in a :class:`MetricsRegistry`. Gauge
        callables only take the meter lock (never the registry lock), so
        snapshot's outside-the-lock gauge evaluation cannot deadlock."""
        registry.register_gauge("usage_noisy_tenants",
                                lambda: float(len(self.noisy())))
        registry.register_gauge("usage_tracked_tenants",
                                lambda: float(len(self.totals())))

    def state(self, now: Optional[float] = None) -> Dict[str, Any]:
        """The ``/usage`` payload: windowed series, lifetime totals, and
        the detector verdict with per-tenant dominant-share scores."""
        if now is None:
            now = self._clock()
        shares = self.dominant_shares(now=now)
        return {
            "window_s": self.window_s,
            "buckets": self.buckets,
            "noisy_threshold": self.noisy_threshold,
            "window": self.window_usage(now=now),
            "totals": self.totals(),
            "dominant_share": {t: {"score": score, **rec}
                               for t, (score, rec) in shares.items()},
            "noisy": self.noisy(now=now),
        }

    def noisy_state(self) -> Dict[str, Any]:
        """Compact detector summary for ``/healthz``."""
        return {"noisy_threshold": self.noisy_threshold,
                "noisy": self.noisy()}
