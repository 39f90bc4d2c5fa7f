"""Closed-loop autoscaler: load-driven shard fleet + executor pool sizing.

The paper's VirtualCluster design (§III) shares one super cluster among many
tenant control planes, which only pays off when the *control plane itself*
tracks tenant load instead of being provisioned for peak. This module closes
the loop over the two elastic axes the framework already exposes:

- **horizontal (downward)** — the downward syncer fleet: per-shard
  fair-queue depth and reconcile latency drive :meth:`Syncer.resize_shards(n)
  <repro_torch.core.syncer.Syncer.resize_shards>` (consistent-hash ring, ~1/N
  tenant migration per step);
- **horizontal (upward)** — the upward status/event fleet: upward-queue
  depth and upward sync latency drive :meth:`Syncer.resize_upward_shards(n)
  <repro_torch.core.syncer.Syncer.resize_upward_shards>` (same ring mechanics;
  the tenant-visible axis, so it gets its own thresholds and actuator);
- **vertical** — the shared cooperative executor: ready-task backlog per
  thread and quantum latency drive :meth:`CooperativeExecutor.resize(n)
  <repro_torch.core.executor.CooperativeExecutor.resize>` (grow spawns threads,
  shrink drains-and-retires via poison quanta);
- **workload (data plane)** — the serving engine-replica fleet: pending
  requests per replica and fleet-wide TTFT drive
  :meth:`ServingFleet.resize(n) <repro_torch.serving.host.ServingFleet.resize>`
  (desired-state: WorkUnits are created/deleted and node agents
  spawn/drain the live engines). Attached post-construction via
  :meth:`Autoscaler.set_engine_fleet`, absent by default.

Signal flow::

    MetricsRegistry gauges/summaries          (down/up queue depth, down/up
              │                                sync latency, ready backlog,
              ▼                                quantum latency)
        SignalWindow × 6                      (sliding horizon: EWMA +
              │                                percentile aggregation)
              ▼
        ScalingPolicy                         (thresholds, hysteresis,
              │                                cooldowns, min/max bounds)
              ▼
    ┌─ Syncer.resize_shards(n, block=False)        (never parks a pool
    ├─ Syncer.resize_upward_shards(n, block=False)  thread behind an
    └─ CooperativeExecutor.resize(n)                operator resize)

The :class:`Autoscaler` is an ordinary queue-less :class:`Controller` whose
periodic scan is the control tick, so it runs as a cooperative task on the
very pool it scales (sixth controller on the shared runtime) and inherits
health/metrics/lifecycle for free. Decisions are exported as counters
(``autoscaler_scale_total{actuator=...,direction=...}``), live targets and
window aggregates as gauges, and :meth:`Autoscaler.state` feeds ``/healthz``
so a wedged control loop is visible (last decision, current targets,
cooldown remaining).

The tick also hosts **per-tenant WRR weight autotuning**
(``autotune_weights``): each fair queue's per-tenant wait means feed back
into its live WRR weights — a tenant waiting longer than its queue's
average gets proportionally more credit — bounded to [0.5x, 4x] of the
tenant's configured weight, so autotuning can smooth latency for heavy-but-
compliant tenants without ever overriding operator intent wholesale.

Scale-up is multiplicative (default ×2: bursts are met in O(log max) ticks)
and scale-down is halving gated by a *longer* cooldown and a hysteresis
band (``*_down`` thresholds well below the ``*_up`` ones), the classic
flap-damping asymmetry.
"""
from __future__ import annotations

import math
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from .runtime import Controller


class SignalWindow:
    """Sliding-horizon aggregation over one scalar control signal.

    Keeps ``(t, value)`` samples no older than ``horizon`` seconds and
    serves the aggregates scaling decisions want: **EWMA** (smoothed level,
    ``alpha`` per sample) and **percentile** over the retained window (the
    burst detector — a p90 over raw samples reacts faster than any mean).
    Thread-safe: ticks write while gauges/healthz read.

    Memory is bounded: at most ``max_samples`` samples are retained
    regardless of observation rate (the deque drops from the old end, so a
    flood degrades the window toward "most recent max_samples" — the right
    bias for a burst detector). When a ``histogram``
    (:class:`~repro_torch.core.runtime.Histogram`) is wired, every observation
    also feeds it, and once the window saturates — truncated samples mean
    the sorted-sample read no longer sees the full horizon — percentile
    queries delegate to the histogram's bucket walk, which never forgets.
    """

    def __init__(self, horizon: float = 30.0, alpha: float = 0.3,
                 max_samples: int = 1024, histogram: Optional[Any] = None):
        self.horizon = float(horizon)
        self.alpha = float(alpha)
        self.max_samples = max(1, int(max_samples))
        self.histogram = histogram
        self._samples: Deque[Tuple[float, float]] = deque()
        self._ewma: Optional[float] = None
        self._truncated = False    # window has dropped in-horizon samples
        self._lock = threading.Lock()

    def observe(self, value: float, now: Optional[float] = None) -> None:
        now = time.monotonic() if now is None else now
        v = float(value)
        with self._lock:
            self._samples.append((now, v))
            cutoff = now - self.horizon
            while self._samples and self._samples[0][0] < cutoff:
                self._samples.popleft()
            while len(self._samples) > self.max_samples:
                self._samples.popleft()
                self._truncated = True
            self._ewma = (v if self._ewma is None
                          else self.alpha * v + (1 - self.alpha) * self._ewma)
        if self.histogram is not None:
            self.histogram.observe(v)

    def ewma(self) -> float:
        with self._lock:
            return self._ewma if self._ewma is not None else 0.0

    def percentile(self, p: float) -> float:
        with self._lock:
            if not self._samples:
                return 0.0
            truncated = self._truncated
            vals = sorted(v for _, v in self._samples)
        if truncated and self.histogram is not None:
            # the raw window lost in-horizon samples to the cap; the
            # histogram saw every observation, so its estimate is better
            return self.histogram.percentile(p * 100.0)
        idx = min(len(vals) - 1, int(len(vals) * p))
        return vals[idx]

    def last(self) -> float:
        with self._lock:
            return self._samples[-1][1] if self._samples else 0.0

    def __len__(self) -> int:
        with self._lock:
            return len(self._samples)

    def state(self) -> Dict[str, float]:
        return {"ewma": self.ewma(), "p90": self.percentile(0.9),
                "last": self.last(), "n": float(len(self))}


@dataclass
class ScalingPolicy:
    """Thresholds, bounds, and damping for both scaling axes.

    ``*_up`` thresholds trigger growth, ``*_down`` thresholds (set well
    below) permit shrink; the gap is the hysteresis band. A breach must
    persist for ``hysteresis`` consecutive ticks, and actions are spaced by
    ``up_cooldown_s`` / ``down_cooldown_s`` (down longer: shrinking is the
    cheap-to-delay direction). Growth multiplies by ``grow_factor``; shrink
    halves. Defaults suit the in-process benchmarks (sub-second reconciles);
    real deployments tune the policy, not the loop.
    """

    # horizontal: downward shard fleet
    min_shards: int = 1
    max_shards: int = 8
    shard_up_depth: float = 32.0       # p90 of max per-shard queue depth
    shard_down_depth: float = 2.0
    shard_up_latency_s: float = 0.25   # windowed mean reconcile latency
    # horizontal: upward (status/event) shard fleet
    min_upward_shards: int = 1
    max_upward_shards: int = 8
    upward_up_depth: float = 32.0      # p90 of max per-upward-shard depth
    upward_down_depth: float = 2.0
    upward_up_latency_s: float = 0.25  # windowed mean upward sync latency
    # vertical: cooperative executor pool
    min_pool: int = 2
    max_pool: int = 32
    pool_up_backlog: float = 4.0       # p90 ready backlog per pool thread
    pool_down_backlog: float = 0.5
    pool_up_quantum_s: float = 0.05    # windowed mean quantum latency
    # workload: serving engine-replica fleet (fourth actuator; evaluated
    # only when a ServingFleet is attached via set_engine_fleet)
    min_engine_replicas: int = 1
    max_engine_replicas: int = 8
    engine_up_pending: float = 4.0     # p90 pending requests per replica
    engine_down_pending: float = 0.5
    engine_up_ttft_s: float = 1.0      # windowed mean per-request TTFT
    # control-loop damping
    hysteresis: int = 2                # consecutive breaching ticks to act
    up_cooldown_s: float = 3.0
    down_cooldown_s: float = 10.0
    grow_factor: float = 2.0
    # signal windows
    window_s: float = 30.0
    ewma_alpha: float = 0.3
    # per-tenant WRR weight autotuning (runs on the tick; factors bound the
    # retuned weight relative to the tenant's CONFIGURED weight)
    autotune_weights: bool = True
    autotune_min_factor: float = 0.5
    autotune_max_factor: float = 4.0
    # noisy-neighbor advisory (needs a UsageMeter attached): a tenant whose
    # windowed dominant share crosses noisy_threshold has its autotune boost
    # factor multiplied by noisy_dampen BEFORE clamping, so attribution
    # feeds the WRR loop without overriding the operator's weight bounds
    noisy_threshold: float = 2.0
    noisy_dampen: float = 0.5

    def clamp_shards(self, n: int) -> int:
        return max(self.min_shards, min(self.max_shards, n))

    def clamp_upward(self, n: int) -> int:
        return max(self.min_upward_shards, min(self.max_upward_shards, n))

    def clamp_pool(self, n: int) -> int:
        return max(self.min_pool, min(self.max_pool, n))

    def clamp_engine(self, n: int) -> int:
        return max(self.min_engine_replicas,
                   min(self.max_engine_replicas, n))


class _Actuator:
    """Hysteresis + cooldown bookkeeping for one scaling dimension.

    ``clamp`` is the policy's live bound function
    (:meth:`ScalingPolicy.clamp_shards` / :meth:`ScalingPolicy.clamp_pool`),
    read at decision time so post-construction policy changes are honored
    for bounds exactly like they are for thresholds.
    """

    def __init__(self, name: str, policy: ScalingPolicy,
                 clamp: Callable[[int], int]):
        self.name = name
        self.policy = policy
        self.clamp = clamp
        self._up_streak = 0
        self._down_streak = 0
        self._last_scale_t: Optional[float] = None

    def decide(self, cur: int, up_breach: bool, down_breach: bool,
               now: float) -> Optional[int]:
        """Fold this tick's breach verdicts in; return a new target size or
        ``None`` (hold). The caller commits via :meth:`committed` only after
        the actuation actually happened (a contended resize keeps streaks)."""
        p = self.policy
        if up_breach:
            self._up_streak += 1
            self._down_streak = 0
        elif down_breach:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        since = (math.inf if self._last_scale_t is None
                 else now - self._last_scale_t)
        if self._up_streak >= p.hysteresis and since >= p.up_cooldown_s:
            target = self.clamp(max(cur + 1, math.ceil(cur * p.grow_factor)))
            if target > cur:
                return target
        if self._down_streak >= p.hysteresis and since >= p.down_cooldown_s:
            target = self.clamp(cur // 2)
            if target < cur:
                return target
        return None

    def committed(self, now: float) -> None:
        self._last_scale_t = now
        self._up_streak = self._down_streak = 0

    def cooldown_remaining(self, now: float) -> Dict[str, float]:
        p = self.policy
        if self._last_scale_t is None:
            return {"up_s": 0.0, "down_s": 0.0}
        since = now - self._last_scale_t
        return {"up_s": round(max(0.0, p.up_cooldown_s - since), 3),
                "down_s": round(max(0.0, p.down_cooldown_s - since), 3)}


class Autoscaler(Controller):
    """Sixth controller on the shared runtime: the closed scaling loop.

    A queue-less :class:`Controller` whose periodic ``scan`` (every
    ``interval`` seconds) is one control tick: sample signals into the
    :class:`SignalWindow`\\ s, evaluate the :class:`ScalingPolicy` per
    actuator, and actuate ``syncer.resize_shards`` (non-blocking — a
    contended resize lock defers to the next tick rather than parking a
    pool thread) and ``executor.resize``. Pass ``executor=None`` to scale
    only the shard fleet (legacy thread mode has no pool to size).
    """

    def __init__(self, syncer: Any, executor: Optional[Any] = None, *,
                 policy: Optional[ScalingPolicy] = None,
                 interval: float = 0.5, name: str = "autoscaler"):
        super().__init__(name, queue=None, workers=0, scan_interval=interval)
        self.syncer = syncer
        # the pool being *scaled* (usually also the one this task runs on);
        # kept apart from Controller.executor, the scheduling attribute
        self.pool_executor = executor
        # standalone-friendly defaults: decisions land in the registry the
        # signals are read from, and the tick schedules on the pool it
        # scales. A ControllerManager.add() overrides both (same objects in
        # the framework wiring).
        self.metrics = syncer.up_controller.metrics
        self.executor = executor
        self.policy = policy or ScalingPolicy()
        p = self.policy
        self.w_depth = SignalWindow(p.window_s, p.ewma_alpha)
        self.w_latency = SignalWindow(p.window_s, p.ewma_alpha)
        self.w_up_depth = SignalWindow(p.window_s, p.ewma_alpha)
        self.w_up_latency = SignalWindow(p.window_s, p.ewma_alpha)
        self.w_backlog = SignalWindow(p.window_s, p.ewma_alpha)
        self.w_quantum = SignalWindow(p.window_s, p.ewma_alpha)
        self.w_engine_pending = SignalWindow(p.window_s, p.ewma_alpha)
        self.w_engine_ttft = SignalWindow(p.window_s, p.ewma_alpha)
        self._shards_act = _Actuator("shards", p, p.clamp_shards)
        self._upward_act = _Actuator("upward_shards", p, p.clamp_upward)
        self._pool_act = _Actuator("executor_pool", p, p.clamp_pool)
        self._engine_act = _Actuator("engine_replicas", p, p.clamp_engine)
        # the serving data plane's engine fleet (fourth actuator); attached
        # post-construction by ServingFleet.attach via set_engine_fleet
        self.engine_fleet: Optional[Any] = None
        # optional UsageMeter (framework-set): its dominant-share detector
        # feeds the autotune pass as an advisory dampening input
        self.meter: Optional[Any] = None
        self._last_noisy: Dict[str, float] = {}
        self._prev_ttft = (0.0, 0.0)         # cumulative (sum, count)
        self.weight_retunes = 0
        # cumulative (sum, count) per shard-controller NAME: the registry
        # keeps a retired shard's summary and a re-grown shard reuses its
        # name, so per-name baselines survive fleet resizes (a fleet-wide
        # total would go negative on shrink and jump on regrow)
        self._prev_reconcile: Dict[str, Tuple[float, float]] = {}
        self._prev_quanta = (0.0, 0)         # cumulative (seconds, quanta)
        self.decisions: Deque[Dict[str, Any]] = deque(maxlen=64)
        self.ticks = 0
        self.contended_resizes = 0
        self._state_lock = threading.Lock()

    # -- controller hooks ---------------------------------------------------

    def on_start(self) -> None:
        m = self.metrics
        # back the latency windows' percentile reads with registry
        # histograms (wired here, where self.metrics is final): a flood past
        # max_samples degrades the raw deque, but the histogram saw every
        # observation — and the buckets land on /metrics for free
        self.w_latency.histogram = m.histogram("autoscaler_reconcile_seconds")
        self.w_up_latency.histogram = m.histogram("autoscaler_upward_seconds")
        self.w_quantum.histogram = m.histogram("autoscaler_quantum_seconds")
        self.w_engine_ttft.histogram = m.histogram("autoscaler_ttft_seconds")
        m.register_gauge("autoscaler_target_shards",
                         lambda: self.syncer.num_shards)
        m.register_gauge("autoscaler_target_upward_shards",
                         lambda: self.syncer.num_upward_shards)
        if self.pool_executor is not None:
            m.register_gauge("autoscaler_target_pool",
                             lambda: self.pool_executor.pool_size)
        m.register_gauge("autoscaler_shard_depth_p90",
                         lambda: self.w_depth.percentile(0.9))
        m.register_gauge("autoscaler_reconcile_latency_s", self.w_latency.ewma)
        m.register_gauge("autoscaler_upward_depth_p90",
                         lambda: self.w_up_depth.percentile(0.9))
        m.register_gauge("autoscaler_upward_latency_s", self.w_up_latency.ewma)
        m.register_gauge("autoscaler_backlog_per_thread_p90",
                         lambda: self.w_backlog.percentile(0.9))
        m.register_gauge("autoscaler_quantum_latency_s", self.w_quantum.ewma)
        m.register_gauge("autoscaler_ticks", lambda: self.ticks)

    def set_engine_fleet(self, fleet: Any) -> None:
        """Attach the serving fleet as the fourth actuator. Bounds widen to
        include the fleet's configured replica count (same pristine-policy
        treatment as the framework gives the other axes)."""
        self.engine_fleet = fleet
        p = self.policy
        start = int(fleet.desired_replicas)
        p.min_engine_replicas = min(p.min_engine_replicas, start)
        p.max_engine_replicas = max(p.max_engine_replicas, max(start, 1))
        m = self.metrics
        m.register_gauge("autoscaler_target_engine_replicas",
                         lambda: (self.engine_fleet.desired_replicas
                                  if self.engine_fleet else 0))
        m.register_gauge("autoscaler_engine_pending_p90",
                         lambda: self.w_engine_pending.percentile(0.9))
        m.register_gauge("autoscaler_engine_ttft_s", self.w_engine_ttft.ewma)

    def scan(self) -> int:
        """One control tick; returns the number of scaling actions taken."""
        return self.tick()

    # -- the control loop ---------------------------------------------------

    def tick(self, now: Optional[float] = None) -> int:
        now = time.monotonic() if now is None else now
        self._sample(now)
        actions = (self._evaluate_shards(now) + self._evaluate_upward(now)
                   + self._evaluate_pool(now) + self._evaluate_engine(now))
        self._autotune_weights()
        with self._state_lock:
            self.ticks += 1
        return actions

    def _windowed_latency(self, controllers: List[Any]) -> float:
        """Windowed mean reconcile latency across ``controllers`` from the
        cumulative summaries: delta(sum)/delta(count) since the last tick.
        Zero when idle, so the latency window decays and permits shrink."""
        reg = self.syncer.up_controller.metrics
        dsum = dcount = 0.0
        for c in controllers:
            s = reg.summary("reconcile_seconds", controller=c.name)
            psum, pcount = self._prev_reconcile.get(c.name, (0.0, 0.0))
            dsum += s["sum"] - psum
            dcount += s["count"] - pcount
            self._prev_reconcile[c.name] = (s["sum"], s["count"])
        return dsum / dcount if dcount > 0 else 0.0

    def _sample(self, now: float) -> None:
        # hot-shard depth: the max per-shard fair-queue depth is the signal
        # (a single overloaded shard must be able to trigger growth even
        # when the fleet average looks healthy)
        shards = list(self.syncer.shard_controllers)
        depth = max((len(c.queue) for c in shards), default=0)
        self.w_depth.observe(depth, now)
        self.w_latency.observe(self._windowed_latency(shards), now)
        # same two signals on the upward axis (its own shard fleet)
        ushards = list(self.syncer.upward.controllers)
        udepth = max((len(c.queue) for c in ushards), default=0)
        self.w_up_depth.observe(udepth, now)
        self.w_up_latency.observe(self._windowed_latency(ushards), now)
        ex = self.pool_executor
        if ex is not None:
            self.w_backlog.observe(
                ex.ready_backlog() / max(1, ex.pool_size), now)
            qsec, qtot = ex.quanta_seconds, ex.quanta_total
            pqs, pqt = self._prev_quanta
            dq = qtot - pqt
            self._prev_quanta = (qsec, qtot)
            self.w_quantum.observe((qsec - pqs) / dq if dq > 0 else 0.0, now)
        fleet = self.engine_fleet
        if fleet is not None:
            # demand signal: pending requests per live replica (a flooded
            # scheduler with one replica must look worse than the same
            # backlog spread over four)
            live = max(1, int(fleet.live_replicas()))
            self.w_engine_pending.observe(
                fleet.scheduler.pending() / live, now)
            # latency signal: windowed mean TTFT across the whole fleet
            # (delta of the cumulative aggregate summary since last tick)
            s = self.metrics.summary("serving_ttft_seconds")
            psum, pcount = self._prev_ttft
            dsum, dcount = s["sum"] - psum, s["count"] - pcount
            self._prev_ttft = (s["sum"], s["count"])
            self.w_engine_ttft.observe(
                dsum / dcount if dcount > 0 else 0.0, now)

    def _evaluate_shards(self, now: float) -> int:
        p = self.policy
        depth_p90 = self.w_depth.percentile(0.9)
        lat = self.w_latency.ewma()
        up = depth_p90 > p.shard_up_depth or lat > p.shard_up_latency_s
        down = (depth_p90 <= p.shard_down_depth
                and lat <= p.shard_up_latency_s / 2)
        cur = self.syncer.num_shards
        target = self._shards_act.decide(cur, up, down, now)
        if target is None:
            return 0
        moved = self.syncer.resize_shards(target, block=False)
        if moved is None:
            # operator call in flight: keep streaks, retry next tick
            with self._state_lock:
                self.contended_resizes += 1
            self.metrics.inc("autoscaler_resize_contended",
                             controller=self.name)
            return 0
        self._commit("shards", cur, target, now,
                     reason=(f"depth_p90={depth_p90:.1f} "
                             f"latency={lat * 1e3:.1f}ms"),
                     extra={"tenants_moved": len(moved)})
        return 1

    def _evaluate_upward(self, now: float) -> int:
        """The third actuator: upward fleet sizing from upward-queue depth
        and upward sync latency (the tenant-visible axis)."""
        p = self.policy
        depth_p90 = self.w_up_depth.percentile(0.9)
        lat = self.w_up_latency.ewma()
        up = depth_p90 > p.upward_up_depth or lat > p.upward_up_latency_s
        down = (depth_p90 <= p.upward_down_depth
                and lat <= p.upward_up_latency_s / 2)
        cur = self.syncer.num_upward_shards
        target = self._upward_act.decide(cur, up, down, now)
        if target is None:
            return 0
        moved = self.syncer.resize_upward_shards(target, block=False)
        if moved is None:
            # operator call in flight: keep streaks, retry next tick
            with self._state_lock:
                self.contended_resizes += 1
            self.metrics.inc("autoscaler_resize_contended",
                             controller=self.name)
            return 0
        self._commit("upward_shards", cur, target, now,
                     reason=(f"upward_depth_p90={depth_p90:.1f} "
                             f"upward_latency={lat * 1e3:.1f}ms"),
                     extra={"tenants_moved": len(moved)})
        return 1

    def _evaluate_pool(self, now: float) -> int:
        ex = self.pool_executor
        if ex is None:
            return 0
        p = self.policy
        backlog_p90 = self.w_backlog.percentile(0.9)
        quantum = self.w_quantum.ewma()
        up = backlog_p90 > p.pool_up_backlog or quantum > p.pool_up_quantum_s
        down = (backlog_p90 <= p.pool_down_backlog
                and quantum <= p.pool_up_quantum_s / 2)
        cur = ex.pool_size
        target = self._pool_act.decide(cur, up, down, now)
        if target is None:
            return 0
        ex.resize(target)
        self._commit("executor_pool", cur, target, now,
                     reason=(f"backlog/thread_p90={backlog_p90:.2f} "
                             f"quantum={quantum * 1e3:.2f}ms"))
        return 1

    def _evaluate_engine(self, now: float) -> int:
        """The fourth actuator: engine-replica fleet sizing from serving
        backlog per replica and fleet-wide TTFT (the tenant-facing
        data-plane axis). Actuates ``ServingFleet.resize`` — desired-state:
        the fleet's reconcile turns it into WorkUnit create/delete."""
        fleet = self.engine_fleet
        if fleet is None:
            return 0
        p = self.policy
        pending_p90 = self.w_engine_pending.percentile(0.9)
        ttft = self.w_engine_ttft.ewma()
        up = (pending_p90 > p.engine_up_pending
              or ttft > p.engine_up_ttft_s)
        down = (pending_p90 <= p.engine_down_pending
                and ttft <= p.engine_up_ttft_s / 2)
        cur = int(fleet.desired_replicas)
        target = self._engine_act.decide(cur, up, down, now)
        if target is None:
            return 0
        fleet.resize(target)
        self._commit("engine_replicas", cur, target, now,
                     reason=(f"pending/replica_p90={pending_p90:.1f} "
                             f"ttft={ttft * 1e3:.1f}ms"))
        return 1

    def _autotune_weights(self) -> int:
        """Feed each fair queue's fresh per-tenant wait metrics back into
        its live WRR weights, bounded to [min_factor, max_factor] x the
        tenant's configured weight. Returns the number of weights changed.

        The boost factor is the tenant's wait excess *demand-normalized* by
        its throughput share: ``(wait / overall_wait) * (fair_n / n)``. A
        queue-flooding tenant's long waits are self-inflicted and come with
        a proportionally large sample count, so the two ratios cancel and
        the flooder earns NO boost — only genuinely under-served tenants
        (long waits at modest throughput) are raised, preserving the
        Fig.11 isolation story the fair queue exists for."""
        p = self.policy
        if not p.autotune_weights:
            return 0
        sy = self.syncer
        changed = 0
        # advisory noisy-neighbor input: dominant-share scores from the
        # usage meter (when attached) dampen the boost of tenants already
        # consuming well past their fair share on some resource axis
        noisy: Dict[str, float] = {}
        um = self.meter
        if um is not None and p.noisy_dampen < 1.0:
            noisy = {r["tenant"]: r["score"]
                     for r in um.noisy(p.noisy_threshold)}
        with self._state_lock:
            self._last_noisy = dict(noisy)
        queues = ([c.queue for c in sy.shard_controllers]
                  + [c.queue for c in sy.upward.controllers])
        for q in queues:
            if not getattr(q, "fair", False):
                continue
            stats = q.tenant_wait_stats()
            if len(stats) < 2:       # one tenant: nothing to rebalance
                continue
            overall = sum(m for _, m in stats.values()) / len(stats)
            fair_n = sum(n for n, _ in stats.values()) / len(stats)
            if overall <= 0 or fair_n <= 0:
                continue
            for tenant, (n, mean_wait) in stats.items():
                reg = sy.tenants.get(tenant)     # GIL-atomic dict read
                if reg is None:
                    continue
                base = max(1, int(reg.plane.weight))
                factor = (mean_wait / overall) * (fair_n / max(1, n))
                if tenant in noisy:
                    factor *= p.noisy_dampen
                    self.metrics.inc("autoscaler_noisy_dampened",
                                     tenant=tenant)
                factor = min(p.autotune_max_factor,
                             max(p.autotune_min_factor, factor))
                if q.set_weight(tenant, round(base * factor)):
                    changed += 1
        if changed:
            with self._state_lock:
                self.weight_retunes += changed
            self.metrics.inc("autoscaler_weight_retunes", float(changed),
                             controller=self.name)
        return changed

    def _commit(self, actuator: str, cur: int, target: int, now: float,
                reason: str, extra: Optional[Dict[str, Any]] = None) -> None:
        act = {"shards": self._shards_act,
               "upward_shards": self._upward_act,
               "executor_pool": self._pool_act,
               "engine_replicas": self._engine_act}[actuator]
        act.committed(now)
        direction = "up" if target > cur else "down"
        decision = {"actuator": actuator, "from": cur, "to": target,
                    "direction": direction, "reason": reason,
                    "t_monotonic": now}
        if extra:
            decision.update(extra)
        with self._state_lock:
            self.decisions.append(decision)
        self.metrics.inc("autoscaler_scale_total", controller=self.name,
                         actuator=actuator, direction=direction)

    # -- observability ------------------------------------------------------

    def state(self) -> Dict[str, Any]:
        """Wedge-visible loop state for ``/healthz``: last decision, live
        targets, per-actuator cooldown remaining, and signal aggregates."""
        now = time.monotonic()
        with self._state_lock:
            last = dict(self.decisions[-1]) if self.decisions else None
            ticks = self.ticks
            contended = self.contended_resizes
            retunes = self.weight_retunes
            noisy = dict(self._last_noisy)
        if last is not None:
            last["age_s"] = round(now - last.pop("t_monotonic"), 3)
        ex = self.pool_executor
        return {
            "last_decision": last,
            "targets": {"shards": self.syncer.num_shards,
                        "upward_shards": self.syncer.num_upward_shards,
                        "executor_pool": ex.pool_size if ex else None,
                        "engine_replicas": (
                            self.engine_fleet.desired_replicas
                            if self.engine_fleet else None)},
            "cooldown_remaining_s": {
                "shards": self._shards_act.cooldown_remaining(now),
                "upward_shards": self._upward_act.cooldown_remaining(now),
                "executor_pool": self._pool_act.cooldown_remaining(now),
                "engine_replicas": self._engine_act.cooldown_remaining(now),
            },
            "signals": {"shard_depth": self.w_depth.state(),
                        "reconcile_latency_s": self.w_latency.state(),
                        "upward_depth": self.w_up_depth.state(),
                        "upward_latency_s": self.w_up_latency.state(),
                        "backlog_per_thread": self.w_backlog.state(),
                        "quantum_latency_s": self.w_quantum.state(),
                        "engine_pending": self.w_engine_pending.state(),
                        "engine_ttft_s": self.w_engine_ttft.state()},
            "ticks": ticks,
            "contended_resizes": contended,
            "weight_retunes": retunes,
            "noisy_neighbors": noisy,
        }

    def scale_events(self) -> List[Dict[str, Any]]:
        """Chronological copy of the recent decision history (benchmarks)."""
        with self._state_lock:
            return [dict(d) for d in self.decisions]
