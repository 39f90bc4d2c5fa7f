"""The span lane of ``repro_torch.core.trace.Tracer`` and the spans that a
serving engine and its drive loop record on it.

On the CPU: the lane's totals against its ring, before and after the ring
wraps; an engine with ``tracer`` None creates no timing event and records
nothing, whatever it did while traced; a traced step records
``engine.step.launch`` / ``.wait`` / ``.book`` in order and without
overlap, and a traced admit call the five ``engine.admit.*`` spans of each
bucket group (admission graphed through a stand-in capture, as
``tests/test_torch_admit_graph.py`` does); the device totals from timing
events, with a stand-in ``torch.cuda.Event`` that reads the host's clock;
the drive loop of a hosted replica records ``replica.take`` /
``.finish`` / ``.park``. On the card (marker ``cuda``): the device clock
across replayed step graphs.
"""
import contextlib
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.core.trace import Tracer
from repro_torch.models import init_params
from repro_torch.serving import GenerationEngine, Request, SlotScheduler
from repro_torch.serving import engine as engine_mod
from repro_torch.serving.host import EngineReplica

F32 = torch.float32
MAX_LEN = 40
STEP = ("engine.step.launch", "engine.step.wait", "engine.step.book")
ADMIT = ("engine.admit.stage", "engine.admit.launch", "engine.admit.wait",
         "engine.admit.book", "engine.admit.capture")


@pytest.fixture(scope="module")
def model():
    cfg = reduced(get_config("qwen2-7b"), n_layers=2)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu", dtype=F32)
    return cfg, params


def _engine(model, slots=4):
    cfg, params = model
    return GenerationEngine(cfg, params, slots=slots, max_len=MAX_LEN,
                            compute_dtype=F32, device="cpu")


def _requests(vocab, lengths, max_new, uid0=0, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(uid0 + i, rng.integers(0, vocab, n).astype(np.int32), m)
            for i, (n, m) in enumerate(zip(lengths, max_new))]


class _ClockEvent:
    """``torch.cuda.Event`` for the CPU: ``record`` reads the host's clock,
    ``elapsed_time`` gives ms between two records. Counts constructions."""
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.at = None

    def record(self, stream=None):
        self.at = time.monotonic()

    def elapsed_time(self, end):
        return (end.at - self.at) * 1e3


@pytest.fixture
def clock_events(monkeypatch):
    monkeypatch.setattr(_ClockEvent, "made", 0)
    monkeypatch.setattr(torch.cuda, "Event", _ClockEvent)
    return _ClockEvent


def _timed(engine):
    """A CPU engine set to time its device work as a card engine does."""
    engine._timed = True
    return engine


# ---------------------------------------------------------------- the lane

@pytest.mark.parametrize("n", [5, 8, 21])
def test_lane_totals_match_ring_and_outlive_its_wrap(monkeypatch, n):
    """Totals count every span and duration; the ring keeps the last
    ``lane_capacity`` spans (8 here), and while it has not wrapped its
    counts and seconds are the totals'. ``lane_add`` adds to the totals
    alone; the sampled request ring stays empty."""
    monkeypatch.setattr(Tracer, "lane_capacity", 8)
    tr = Tracer()
    for i in range(n):
        tr.lane_span("a" if i % 3 else "b", float(i), i + 0.25 * (i % 4),
                     (i,))
    tr.lane_add("dev", 0.5)
    tr.lane_add("dev", 0.25)
    ring, totals = tr.lane_records(), tr.lane_totals()
    assert [r[3] for r in ring] == [(i,) for i in range(max(0, n - 8), n)]
    want = {}
    for i in range(n):
        c, s = want.get("a" if i % 3 else "b", (0, 0.0))
        want["a" if i % 3 else "b"] = (c + 1, s + 0.25 * (i % 4))
    want["dev"] = (2, 0.75)
    assert totals.keys() == want.keys()
    for name, (c, s) in want.items():
        assert totals[name][0] == c and totals[name][1] == pytest.approx(s)
    if n <= 8:
        for name in ("a", "b"):
            in_ring = [r for r in ring if r[0] == name]
            assert totals[name] == (len(in_ring), pytest.approx(
                sum(e - s for _, s, e, _ in in_ring)))
    assert tr.spans() == [] and tr.stats()["started"] == 0


def test_lane_takes_spans_from_many_threads():
    """More threads than cores, switching as often as the interpreter
    allows, each record 500 spans and 500 durations: no count is lost."""
    tr = Tracer()
    n = 4 * (os.cpu_count() or 4)

    def work():
        for i in range(500):
            tr.lane_span("x", 0.0, 0.001)
            tr.lane_add("y", 0.002)
    threads = [threading.Thread(target=work) for _ in range(n)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    totals = tr.lane_totals()
    assert totals["x"][0] == totals["y"][0] == 500 * n
    assert totals["x"][1] == pytest.approx(0.5 * n)
    assert totals["y"][1] == pytest.approx(1.0 * n)
    assert len(tr.lane_records()) == 500 * n


# ---------------------------------------------------------------- the engine

def test_untraced_engine_creates_no_event_and_records_nothing(
        model, clock_events):
    """``tracer`` None: admit calls and steps create no timing event and
    record no span, also after a traced stretch (the tracer's lane does not
    grow once ``tracer`` is None again); a tracer set on the built engine
    takes effect at its next call."""
    cfg, _ = model
    eng = _timed(_engine(model))
    eng.admit_many(_requests(cfg.vocab, (5, 12), (6, 6)))
    eng.step()
    assert clock_events.made == 0
    tr = eng.tracer = Tracer()
    eng.step()
    assert clock_events.made == 4
    seen = len(tr.lane_records())
    assert seen == 3
    eng.tracer = None
    eng.admit_many(_requests(cfg.vocab, (7,), (4,), uid0=10))
    while eng.active_slots():
        eng.step()
    assert len(tr.lane_records()) == seen and clock_events.made == 4
    assert tr.lane_totals()["engine.step.device"][0] == 1


def _no_overlap(records):
    for (_, _, end, _), (_, start, _, _) in zip(records, records[1:]):
        assert end <= start


def test_traced_step_records_launch_wait_book_in_order(model, clock_events):
    """Each step: launch, wait, book, in that order, one after the other.
    Device totals: one ``engine.step.device`` a step, one
    ``engine.step.gap`` for each step that follows a step with no admit call
    between (5 steps, an admission after the 2nd: 3 gaps), all >= 0."""
    cfg, _ = model
    eng = _timed(_engine(model))
    tr = eng.tracer = Tracer()
    eng.admit_many(_requests(cfg.vocab, (5, 12), (9, 9)))
    for i in range(5):
        if i == 2:
            eng.admit_many(_requests(cfg.vocab, (3,), (9,), uid0=5))
        eng.step()
    steps = [r for r in tr.lane_records() if r[0].startswith("engine.step")]
    assert [r[0] for r in steps] == list(STEP) * 5
    _no_overlap(steps)
    totals = tr.lane_totals()
    assert totals["engine.step.device"][0] == 5
    assert totals["engine.step.device"][1] > 0
    assert totals["engine.step.gap"][0] == 3
    assert totals["engine.step.gap"][1] >= 0
    assert totals["engine.admit.device"][0] == 3      # one a bucket group
    for name in STEP:
        assert totals[name][0] == 5


class _NullStream:
    def wait_stream(self, other):
        pass


class _ReplayingGraph:
    def __init__(self, body):
        self.body = body

    def replay(self):
        self.body()


@pytest.fixture
def stand_in_capture(monkeypatch):
    """Graphed admission on the CPU: a capture returns a graph whose replay
    runs the body; streams are stand-ins."""
    def capture(body, stream, *, pool=None, warmup=None):
        if warmup is not None:
            warmup()
        return _ReplayingGraph(body), {}
    monkeypatch.setattr(engine_mod, "_capture_graph", capture)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _NullStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())


def test_traced_admit_records_five_spans_per_bucket_group(
        model, stand_in_capture, clock_events):
    """A graph-admitting engine's first call of two shapes records, per
    bucket group: stage, launch (rows, bucket, "eager"), wait, book and
    capture (not skipped), one after the other; the second round replays
    both shapes (launch "graphed", no capture). The public counters hold
    the captures, their seconds and the replays."""
    cfg, _ = model
    eng = _timed(_engine(model))
    eng._graph_admit = True
    eng._capture_stream = _NullStream()
    eng._admit_pool = None
    tr = eng.tracer = Tracer()
    for rnd in range(2):
        tr_before = len(tr.lane_records())
        eng.admit_many(_requests(cfg.vocab, (5, 12, 9, 3), (3, 3, 3, 3),
                                 uid0=10 * rnd))
        admits = [r for r in tr.lane_records()[tr_before:]
                  if r[0].startswith("engine.admit")]
        kind = "eager" if rnd == 0 else "graphed"
        names = ADMIT if rnd == 0 else ADMIT[:4]
        assert [r[0] for r in admits] == list(names) * 2
        _no_overlap(admits)
        launches = [r[3] for r in admits if r[0] == "engine.admit.launch"]
        assert launches == [(2, 8, kind), (2, 16, kind)]
        if rnd == 0:
            assert [r[3] for r in admits
                    if r[0] == "engine.admit.capture"] == [(False,)] * 2
        while eng.active_slots():
            eng.step()
    c = eng.counters()
    assert (c["admit_captures"], c["admit_replays"]) == (2, 2)
    assert c["capture_s"] > 0 and c["captures_skipped"] == 0
    assert tr.lane_totals()["engine.admit.device"][0] == 4


def test_counters_are_public_and_dropped_counter_is_gone(model):
    eng = _engine(model)
    assert set(eng.counters()) == {
        "steps", "admit_calls", "admitted", "host_syncs", "admit_replays",
        "admit_captures", "capture_s", "captures_skipped", "moe_pairs",
        "moe_pairs_dropped"}
    assert not hasattr(eng, "full_cache_copies")
    assert eng.tracer is None


# ---------------------------------------------------------------- the drive loop

def test_drive_loop_records_take_finish_park(model):
    """A hosted replica whose engine is traced: its drive thread records
    ``replica.take`` before each admission, ``replica.finish`` around the
    callbacks of finished requests (one a request here), ``replica.park``
    while idle; none of its spans and the engine's overlap."""
    cfg, _ = model
    eng = _engine(model, slots=2)
    tr = eng.tracer = Tracer()
    sched = SlotScheduler()
    sched.register_tenant("t", 1)
    finished, done = [], threading.Event()

    def on_finished(req):
        finished.append(req)
        if len(finished) == 5:
            done.set()
    rep = EngineReplica("ns/engine-0", "node-0", eng, sched, on_finished)
    rep.start()
    try:
        for r in _requests(cfg.vocab, (4, 9, 6, 3, 11), (3, 1, 4, 2, 3)):
            sched.submit("t", r)
        assert done.wait(timeout=120)
        time.sleep(0.12)                  # long enough to park
    finally:
        rep.stop()
        rep.join(timeout=60)
    assert not rep._thread.is_alive()
    recs = tr.lane_records()
    names = {r[0] for r in recs}
    assert {"replica.take", "replica.finish", "replica.park"} <= names
    assert {"engine.step.launch", "engine.admit.launch"} <= names
    _no_overlap(sorted(recs, key=lambda r: r[1]))
    assert tr.lane_totals()["replica.finish"][0] <= len(finished) == 5
    first_take = min(r[1] for r in recs if r[0] == "replica.take")
    assert first_take <= min(r[1] for r in recs
                             if r[0] == "engine.admit.stage")


# ---------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_replayed_steps_read_the_device_clock():
    """A graphed engine on the card, traced: every replayed step adds its
    graph's device time (> 0), every step after a step its gap (>= 0), and
    the admit call its device time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and events have no "
                    "CPU mode")
    cuda = torch.device("cuda")
    cfg = reduced(get_config("qwen2-7b"), n_layers=2)
    params = init_params(cfg, generator=torch.Generator(device=cuda)
                         .manual_seed(5), device=cuda, dtype=torch.bfloat16)
    eng = GenerationEngine(cfg, params, slots=3, max_len=MAX_LEN,
                           device=cuda)
    assert eng._graph is not None
    tr = eng.tracer = Tracer()
    eng.admit_many(_requests(cfg.vocab, (5, 7), (8, 8)))
    steps = 0
    while eng.active_slots():
        eng.step()
        steps += 1
    totals = tr.lane_totals()
    n, s = totals["engine.step.device"]
    assert n == steps >= 6 and s > 0
    n_gap, s_gap = totals["engine.step.gap"]
    assert n_gap == steps - 1 and s_gap >= 0
    assert totals["engine.admit.device"][0] == 1
    assert totals["engine.admit.device"][1] > 0
