"""Host-clock spans around an engine's two public calls, from outside the
program: ``admit_many`` and ``step`` are wrapped on the engine object by
the benchmark's engine factory, in a traced run only (the per-layer
metrics read them; the end-to-end metrics read the requests). Both calls
end in a host sync, so a span is the call's whole time. Each span keeps
what the counts of operations and bytes need: the rows, buckets and true
prompt lengths of an admit call, and the live slots and their contexts
at a step."""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .admission import bucket


@dataclass
class AdmitSpan:
    t0: int                     # time.monotonic_ns
    t1: int
    groups: List[Tuple[int, int, List[int]]]   # k, bucket, true lengths


@dataclass
class StepSpan:
    t0: int
    t1: int
    n_active: int
    ctx_sum: int                # contexts of the live slots, new token in


@dataclass
class Probe:
    """The spans of one engine (``exact``: it admits at exact lengths)."""
    max_len: int
    exact: bool = False
    admits: List[AdmitSpan] = field(default_factory=list)
    steps: List[StepSpan] = field(default_factory=list)
    lock: threading.Lock = field(default_factory=threading.Lock)
    gate: threading.Condition = field(default_factory=threading.Condition)
    closed: bool = False
    in_call: int = 0

    def _enter(self) -> None:
        with self.gate:
            while self.closed:
                self.gate.wait()
            self.in_call += 1

    def _leave(self) -> None:
        with self.gate:
            self.in_call -= 1
            self.gate.notify_all()

    def hold(self) -> None:
        """Keep the drive thread out of the engine's calls: returns once no
        call is in progress; the next one waits for ``release``."""
        with self.gate:
            self.closed = True
            while self.in_call:
                self.gate.wait()

    def release(self) -> None:
        with self.gate:
            self.closed = False
            self.gate.notify_all()

    def attach(self, engine) -> None:
        admit_many, step = engine.admit_many, engine.step

        def admit_spanned(reqs):
            take = list(reqs[:len(engine.free_slots())])
            if not take:
                return admit_many(reqs)
            groups: Dict[int, List[int]] = {}
            for r in take:
                n = int(np.asarray(r.prompt).reshape(-1).shape[0])
                groups.setdefault(bucket(n, self.max_len, self.exact),
                                  []).append(n)
            self._enter()
            try:
                t0 = time.monotonic_ns()
                out = admit_many(reqs)
                t1 = time.monotonic_ns()
            finally:
                self._leave()
            with self.lock:
                self.admits.append(AdmitSpan(t0, t1, [
                    (len(v), b, v) for b, v in sorted(groups.items())]))
            return out

        def step_spanned():
            live = [i for i, r in enumerate(engine.slot_req) if r is not None]
            ctx = int(sum(int(engine.lengths[i]) + 1 for i in live))
            self._enter()
            try:
                t0 = time.monotonic_ns()
                out = step()
                t1 = time.monotonic_ns()
            finally:
                self._leave()
            if live:
                with self.lock:
                    self.steps.append(StepSpan(t0, t1, len(live), ctx))
            return out

        engine.admit_many = admit_spanned
        engine.step = step_spanned

    def between(self, lo: int, hi: int):
        """(admit spans, step spans) that ended inside [lo, hi)."""
        with self.lock:
            return ([a for a in self.admits if lo <= a.t1 < hi],
                    [s for s in self.steps if lo <= s.t1 < hi])

    def within(self, lo: int, hi: int):
        """(admit spans, step spans) wholly inside [lo, hi)."""
        with self.lock:
            return ([a for a in self.admits if a.t0 >= lo and a.t1 < hi],
                    [s for s in self.steps if s.t0 >= lo and s.t1 < hi])

    def spans(self, lo: int, hi: int) -> List[Tuple[str, int, int]]:
        admits, steps = self.between(lo, hi)
        return ([("admit", a.t0, a.t1) for a in admits]
                + [("step", s.t0, s.t1) for s in steps])
