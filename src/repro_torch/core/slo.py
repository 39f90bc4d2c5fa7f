"""Per-tenant SLO tracking: objective targets, rolling compliance, burn rate.

An :class:`SLO` names a latency objective ("propagation under 1s for 99% of
objects"); the :class:`SLOTracker` counts good/total observations per
(tenant, objective) in a rolling bucketed window and reports compliance and
**burn rate** — the ratio of the actual error rate to the error budget
implied by the target. Burn rate 1.0 means the tenant is consuming budget
exactly as fast as the objective allows; above 1.0 the objective will be
breached if the rate holds (the standard multiwindow-burn-rate alerting
quantity, here over a single rolling window).

Observations come from the tracing layer (the end-to-end propagation span
closing in the upward pipeline) and the serving plane (TTFT at request
finish). The tracker itself is tracer-independent and cheap enough to be
always on: one lock, a handful of ints per bucket.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class SLO:
    """A latency objective: ``target`` fraction of observations at or under
    ``threshold_s``, judged over a rolling ``window_s``."""
    name: str
    threshold_s: float
    target: float = 0.99
    window_s: float = 300.0


#: Objectives tracked out of the box. "propagation" is the paper's
#: tenant-write -> status-return path; "serving_ttft" is time to first token.
DEFAULT_OBJECTIVES: Tuple[SLO, ...] = (
    SLO("propagation", threshold_s=1.0, target=0.99, window_s=300.0),
    SLO("serving_ttft", threshold_s=0.5, target=0.95, window_s=300.0),
)

# rolling window is chopped into this many buckets; expiry granularity is
# window_s / buckets
_BUCKETS = 30


class SLOTracker:
    """Rolling good/total counts per (tenant, objective), surfaced on
    ``/healthz``. Unknown objective names are ignored (callers don't need
    to know which objectives a deployment configured)."""

    def __init__(self, objectives: Tuple[SLO, ...] = DEFAULT_OBJECTIVES,
                 buckets: int = _BUCKETS):
        self.objectives: Dict[str, SLO] = {o.name: o for o in objectives}
        self.buckets = max(2, int(buckets))
        self._lock = threading.Lock()
        # (tenant, objective) -> deque of [bucket_start, good, total]
        self._series: Dict[Tuple[str, str], Deque[List[float]]] = {}

    def observe(self, objective: str, tenant: str, value_s: float,
                now: Optional[float] = None) -> None:
        slo = self.objectives.get(objective)
        if slo is None:
            return
        if now is None:
            now = time.monotonic()
        width = slo.window_s / self.buckets
        bucket_start = now - (now % width)
        good = 1 if value_s <= slo.threshold_s else 0
        key = (tenant, objective)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = deque()
            if series and series[-1][0] == bucket_start:
                series[-1][1] += good
                series[-1][2] += 1
            else:
                series.append([bucket_start, good, 1])
            self._expire(series, slo, now)

    @staticmethod
    def _expire(series: Deque[List[float]], slo: SLO, now: float) -> None:
        horizon = now - slo.window_s
        while series and series[0][0] < horizon:
            series.popleft()

    def state(self, now: Optional[float] = None) -> Dict[str, Dict[str, Dict[str, float]]]:
        """``{tenant: {objective: {...compliance/burn_rate/...}}}`` over the
        rolling window. Tenants with no observations are absent."""
        if now is None:
            now = time.monotonic()
        out: Dict[str, Dict[str, Dict[str, float]]] = {}
        with self._lock:
            items = [(k, [list(b) for b in v]) for k, v in self._series.items()]
        for (tenant, objective), series_copy in items:
            slo = self.objectives[objective]
            horizon = now - slo.window_s
            good = total = 0
            for bucket_start, g, t in series_copy:
                if bucket_start >= horizon:
                    good += int(g)
                    total += int(t)
            if total == 0:
                continue
            compliance = good / total
            budget = 1.0 - slo.target
            if budget <= 0.0:
                burn = 0.0 if compliance >= 1.0 else float("inf")
            else:
                burn = (1.0 - compliance) / budget
            out.setdefault(tenant, {})[objective] = {
                "target": slo.target,
                "threshold_s": slo.threshold_s,
                "window_s": slo.window_s,
                "total": float(total),
                "good": float(good),
                "compliance": compliance,
                "burn_rate": burn,
                "breaching": compliance < slo.target,
            }
        return out
