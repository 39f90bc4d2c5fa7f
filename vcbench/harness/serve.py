"""The serving cells: tenants of a live ``VirtualClusterFramework`` send
their requests through ``ServingFleet.submit`` to one engine replica, a
WorkUnit that the control plane places and a node agent starts.

Set-up makes the weights from the seed, starts the framework, registers
the tenants from their control planes, resizes the fleet to one replica
(the engine factory builds the engine, which captures its decode step,
and warms the admission shapes the mix lists, those its traffic reaches),
and sends one request through the fleet. The window then replays the
mix's schedule: open-loop tenants submit at their due times, closed-loop
tenants keep their requests in flight. In a traced run the probe's spans
go around the engine's calls, and the window profiles one slice of it.
"""
from __future__ import annotations

import gc
import itertools
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import kineto, traffic
from .manifest import reference
from .probe import Probe
from .weights import make_weights

NS = 1_000_000_000
WAIT_S = 60         # how long past its close a window waits for answers


@dataclass
class Sent:
    uid: int
    tenant: str
    due_ns: int
    sent_ns: int
    prompt: np.ndarray
    max_new: int


@dataclass
class ServeWindow:
    """What one window sent, and what came back. ``sent`` leaves out what
    closed-loop tenants sent in the lead-in; ``served`` is every request
    the fleet has finished so far, lead-in and set-up included."""
    t0: int
    t1: int
    sent: List[Sent]
    done: Dict[int, Any]
    waited_until: int
    foreground: List[str]
    counters: Tuple[Dict[str, int], Dict[str, int]]
    served: List[Any]
    slice: Optional[kineto.Slice] = None
    slice_mono: Optional[Tuple[int, int]] = None
    closed_sent: int = 0

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) / NS

    def foreground_sent(self) -> List[Sent]:
        return [s for s in self.sent if s.tenant in self.foreground
                and self.t0 <= s.due_ns < self.t1]


class ServeCell:
    """One serving cell's system under test, set up once."""

    def __init__(self, cell, seed: int, device: torch.device, log=print,
                 trace: bool = False):
        t = time.monotonic()
        from repro_torch.core import VirtualClusterFramework
        from repro_torch.models.config import ModelConfig
        from repro_torch.serving import ServingFleet
        phases = {"program imports": time.monotonic() - t}

        self.cell, self.mix, self.log = cell, cell.mix, log
        self.model = cell.config["model"]
        self.dep = cell.config["deployment"]
        self.cfg = ModelConfig(**self.model)
        self.device = device
        # the engine admits every prompt at its exact length, eagerly
        self.exact = bool(reference(cell).exact_admission(self.model))
        t = time.monotonic()
        self.weights = make_weights(cell.config, seed, device,
                                    torch.bfloat16)
        if device.type == "cuda":
            torch.cuda.synchronize()
        phases["weights"] = time.monotonic() - t
        self.probe = (Probe(self.dep["max_len"], self.exact) if trace
                      else None)
        self.engines: List[Any] = []
        self.errors: List[str] = []
        self.closed = {t["name"] for t in self.mix["tenants"]
                       if t["arrival"] == "closed"}
        self.warmed: List[Tuple[int, int]] = []
        if trace and device.type == "cuda":
            t = time.monotonic()
            _warm_profiler()
            phases["profiler warm-up"] = time.monotonic() - t
        self._hook = threading.excepthook
        threading.excepthook = self._thread_error
        t = time.monotonic()
        self.fleet = ServingFleet(self._factory, replicas=0)
        self.fw = VirtualClusterFramework(num_nodes=1, scan_interval=0.0,
                                          heartbeat_interval=3600)
        self.fleet.attach(self.fw)
        self.fw.start()
        for tenant in self.mix["tenants"]:
            self.fleet.register_tenant(self.fw.add_tenant(
                tenant["name"], weight=int(tenant.get("weight", 1))))
        phases["framework and tenants"] = time.monotonic() - t
        t0 = time.monotonic()
        self.fleet.resize(int(self.dep.get("replicas", 1)))
        self._wait(lambda: self.fleet.live_replicas()
                   == int(self.dep.get("replicas", 1)), 900.0)
        self.replica_ready_s = time.monotonic() - t0
        phases["replica"] = self.replica_ready_s
        t = time.monotonic()
        first = self.mix["tenants"][0]["name"]
        uid = self.fleet.submit(first, np.arange(16, dtype=np.int32) % 997,
                                max_new_tokens=2)
        self._wait(lambda: uid in self.fleet.completed, 300.0)
        phases["first request"] = time.monotonic() - t
        self.phases = phases

    # -- set-up --------------------------------------------------------------

    def _thread_error(self, args) -> None:
        self.errors.append(f"{args.thread.name}: {args.exc_type.__name__}: "
                           f"{args.exc_value}")
        self._hook(args)

    def _wait(self, cond, timeout: float) -> None:
        deadline = time.monotonic() + timeout
        while not cond():
            if self.errors:
                raise RuntimeError("; ".join(self.errors))
            if time.monotonic() > deadline:
                raise TimeoutError("the fleet did not answer in time")
            time.sleep(0.002)

    def _factory(self):
        """The fleet's engine factory: the engine (its constructor captures
        the decode step), then the admission shapes of the mix's
        ``warm_shapes`` ([rows, bucket] pairs), each one eager call and its
        capture, with one-token requests that leave no slot occupied. In a
        traced run the probe's spans then go around the two calls."""
        from repro_torch.serving import GenerationEngine, Request
        t = time.monotonic()
        engine = GenerationEngine(self.cfg, self.weights,
                                  slots=int(self.dep["slots"]),
                                  max_len=int(self.dep["max_len"]),
                                  device=self.device)
        self.engine_build_s = time.monotonic() - t
        rng = np.random.default_rng(0)
        uid = 0
        for k, b in self.mix.get("warm_shapes", []):
            reqs = []
            for _ in range(k):
                uid -= 1
                reqs.append(Request(uid, rng.integers(
                    0, self.cfg.vocab, b).astype(np.int32), 1))
            engine.admit_many(reqs)
            self.warmed.append((k, b))
        if engine.captures_skipped:
            raise RuntimeError(f"{engine.captures_skipped} admission "
                               f"captures skipped in set-up")
        if self.probe is not None:
            self.probe.attach(engine)
        self.engines.append(engine)
        return engine

    # -- a window ------------------------------------------------------------

    def window(self, seed: int, seconds: float, trace: bool = False,
               rate_scale: float = 1.0) -> ServeWindow:
        """Replay the mix's schedule for ``seed`` over ``seconds``. Then
        waits for every request sent to finish, at most ``WAIT_S`` past the
        close (closed-loop tenants stop sending at the close)."""
        sched = traffic.schedule(self.mix, seed, seconds, self.cfg.vocab,
                                 rate_scale)
        engine = self.engines[0]
        before = engine.counters()
        lead = int(float(self.mix.get("lead_in", 0.0)) * NS)
        t0 = time.monotonic_ns() + NS // 50 + lead
        t1 = t0 + int(seconds * NS)
        sent: List[Sent] = []
        sent_lock = threading.Lock()

        def submit(tenant, prompt, max_new, due):
            uid = self.fleet.submit(tenant, prompt, max_new_tokens=max_new)
            with sent_lock:
                sent.append(Sent(uid, tenant, due, time.monotonic_ns(),
                                 prompt, max_new))
            return uid

        closers = []
        for client in sched.closed:
            th = threading.Thread(target=self._closed_loop,
                                  args=(client, submit, t0 - lead, t1),
                                  name=f"client:{client.tenant}", daemon=True)
            th.start()
            closers.append(th)

        events = [(t0 + int(a.due * NS), 0, a) for a in sched.arrivals]
        prof = rf = None
        mark = slice_mono = None
        if trace:       # the slice ends as the window closes
            sl = self.mix.get("slice", {"seconds": 2.0})
            length = int(min(sl["seconds"], 0.5 * seconds) * NS)
            events += [(t1 - length, 1, "start"), (t1, 1, "stop")]
        events.sort(key=lambda e: (e[0], e[1]))
        for when, kind, what in events:
            _sleep_until(when)
            if kind == 0:
                submit(what.tenant, what.prompt, what.max_new, when)
            elif what == "start":
                prof, rf, mark = self._profile_start()
            else:
                slice_mono = self._profile_stop(prof, rf, mark)
        _sleep_until(t1)
        for th in closers:
            th.join()
        wanted = [s.uid for s in sent]
        deadline = t1 + WAIT_S * NS
        while (time.monotonic_ns() < deadline
               and not all(u in self.fleet.completed for u in wanted)):
            if self.errors:
                raise RuntimeError("; ".join(self.errors))
            time.sleep(0.01)
        waited = time.monotonic_ns()
        served = list(self.fleet.completed.values())
        done = {s.uid: self.fleet.completed[s.uid] for s in sent
                if s.uid in self.fleet.completed}
        sent = [s for s in sent if s.sent_ns >= t0]   # not the lead-in
        win = ServeWindow(t0, t1, sent, done, waited, sched.foreground,
                          (before, engine.counters()), served,
                          closed_sent=sum(1 for s in sent if s.tenant
                                          in self.closed))
        if prof is not None:
            win.slice_mono = slice_mono
            win.slice = kineto.profile_slice(
                prof, slice_mono[0], self.probe.spans(*slice_mono))
        return win

    def _profile_start(self):
        """Start the profiler and enter the slice's range. The drive thread
        is held out of the engine's calls meanwhile, and no capture can
        run (``CAPTURE_LOCK``): the profiler's start and stop synchronise
        with the device, which CUDA refuses during another thread's
        capture."""
        from repro_torch.device import CAPTURE_LOCK
        from torch.profiler import ProfilerActivity, profile, record_function
        a = time.monotonic_ns()
        with CAPTURE_LOCK:
            self.probe.hold()
            try:
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
                rf = record_function("vcbench.slice")
                mark = time.monotonic_ns()
                rf.__enter__()
            finally:
                self.probe.release()
        self.log(f"profiler started in {(mark - a) / 1e6:.1f} ms")
        return prof, rf, mark

    def _profile_stop(self, prof, rf, mark):
        """Leave the slice's range and stop the profiler, the drive thread
        held and the device idle (as ``_profile_start``)."""
        from repro_torch.device import CAPTURE_LOCK
        with CAPTURE_LOCK:
            self.probe.hold()
            try:
                rf.__exit__(None, None, None)
                end = time.monotonic_ns()
                if self.device.type == "cuda":
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
            finally:
                self.probe.release()
        self.log(f"profiler stopped in {(time.monotonic_ns() - end) / 1e6:.1f}"
                 f" ms")
        return mark, end

    def _closed_loop(self, client, submit, t0, t1) -> None:
        """Keep ``client.outstanding`` requests in flight from ``t0`` (the
        mix's ``lead_in`` before the window opens, so that the window
        starts with the tenant's requests already in flight) to ``t1``:
        every 10 ms, one new request for each that the fleet finished."""
        pool = itertools.cycle(client.pool)
        _sleep_until(t0)
        flight = []
        for _ in range(client.outstanding):
            prompt, max_new = next(pool)
            flight.append(submit(client.tenant, prompt, max_new,
                                 time.monotonic_ns()))
        while time.monotonic_ns() < t1:
            time.sleep(0.01)
            done = self.fleet.completed
            left = [u for u in flight if u not in done]
            for _ in range(len(flight) - len(left)):
                if time.monotonic_ns() >= t1:
                    break
                prompt, max_new = next(pool)
                left.append(submit(client.tenant, prompt, max_new,
                                   time.monotonic_ns()))
            flight = left

    # -- tear-down -----------------------------------------------------------

    def close(self) -> None:
        """Stop the framework (the replica drains its slots and its thread
        exits) and drop every reference to the engine."""
        self.fw.stop()
        threading.excepthook = self._hook
        self.engines.clear()
        self.fleet = None
        self.fw = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _sleep_until(t_ns: int) -> None:
    while True:
        left = t_ns - time.monotonic_ns()
        if left <= 0:
            return
        time.sleep(min(left / NS, 0.05))


def _warm_profiler() -> None:
    """One short profile, so that the window's slice does not pay the
    profiler's first start."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
