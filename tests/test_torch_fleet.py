"""The control-plane bridge of the PyTorch port: engine replicas hosted as
WorkUnits of a live ``repro_torch.core.VirtualClusterFramework`` and fed
by ``repro_torch.serving.ServingFleet``.

Twins of ``tests/test_serving.py``'s bridge tests (the fleet's replicas,
metrics and scale-down; the agent stopping deleted units; the engine
actuator scaling up and down, and doing nothing without a fleet), run on
the port's own copies of the control plane. Then the port against the JAX
package, at fp32 on the CPU, on weights carried across by
``params_from_jax``:

- each request's greedy tokens from a 2-replica port fleet equal the JAX
  oracle's for that prompt alone (a one-slot JAX ``GenerationEngine``,
  which ``tests/test_serving.py`` holds to its hand-rolled loop);
- a port fleet and a JAX fleet fed the same requests leave the same
  ``serving_*`` counters, gauges and summary counts in
  ``fw.metrics.snapshot()``, the same span tree per finished request and
  the same meter keys;
- a 0 -> 1 resize gives tokens and ``admit_calls``/``steps`` identical to
  a lone ``ContinuousBatcher`` (the replica's first ``take`` sees every
  request, as ``pump`` does);
- requests in flight on a retiring replica finish: none is dropped.

On the card (marker ``cuda``; skipped without one): a fleet of a reduced
config started at 2 replicas, both built (their graphs captured) at once on
pool threads of the framework's executor while the main thread syncs the
device under the capture lock; requests of distinct buckets get a lone
graphed engine's tokens; a third replica built while the others step; the
kernels' launches equal to the per-replica sum.

Tokens are compared exactly (greedy argmax at fp32; on the card both sides
are the same graphed bf16 engine on the same weights).
"""
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.core as tcore
from repro_torch.configs import get_config, reduced
from repro_torch.core import (APIServer, Autoscaler, CooperativeExecutor,
                              ScalingPolicy, Syncer, TenantControlPlane,
                              VirtualClusterFramework, WorkUnit)
from repro_torch.core.agent import MockProvider
from repro_torch.device import CAPTURE_LOCK
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.kernels.grouped_gemm import kernel as gg_kernel
from repro_torch.kernels.mamba_scan import kernel as ms_kernel
from repro_torch.kernels.rwkv6_scan import kernel as rs_kernel
from repro_torch.models import convert, init_params
from repro_torch.serving import (SERVING_NS, ContinuousBatcher,
                                 GenerationEngine, ServingFleet,
                                 SlotScheduler)

F32 = torch.float32
MAX_LEN = 48
CPU = "cpu"
WEIGHTS = {"tenant-a": 1, "tenant-b": 1, "tenant-c": 2}
KERNELS = [fa_kernel.KERNEL, fd_kernel.KERNEL, rs_kernel.KERNEL,
           ms_kernel.KERNEL, gg_kernel.KERNEL]


def wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.005)
    return False


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package and its seeded reduced qwen2-7b (skips where JAX is
    not installed)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro import core as jcore
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models import init_params
    from repro.serving import GenerationEngine as JEngine
    from repro.serving import Request as JRequest
    from repro.serving import ServingFleet as JFleet
    jcfg = j_reduced(j_get_config("qwen2-7b"), n_layers=2)
    jparams = init_params(jax.random.PRNGKey(0), jcfg)
    alone = JEngine(jcfg, jparams, slots=1, max_len=MAX_LEN,
                    compute_dtype=jnp.float32)

    def oracle(prompt, max_new):
        """The JAX engine's greedy tokens for ``prompt`` alone in a
        one-slot engine (``tests/test_serving.py`` holds that engine to the
        hand-rolled prefill + decode loop)."""
        req = JRequest(0, prompt, max_new_tokens=max_new)
        alone.admit_many([req])
        while alone.active_slots():
            alone.step()
        return req.tokens

    def factory():
        return JEngine(jcfg, jparams, slots=2, max_len=MAX_LEN,
                       compute_dtype=jnp.float32)

    return dict(jax=jax, core=jcore, Fleet=JFleet, params=jparams,
                oracle=oracle, factory=factory)


@pytest.fixture(scope="module")
def model(jax_ref):
    """The port's reduced qwen2-7b on the JAX weights (fp32, CPU)."""
    jax = jax_ref["jax"]
    cfg = reduced(get_config("qwen2-7b"), n_layers=2)
    np_tree = jax.tree.map(lambda x: np.asarray(x, np.float32),
                           jax_ref["params"])
    params = convert.params_from_jax(np_tree, cfg, device=CPU,
                                     compute_dtype=F32)
    return cfg, params


@pytest.fixture(scope="module")
def own_model():
    """The port's reduced qwen2-7b on its own seeded weights (no JAX)."""
    cfg = reduced(get_config("qwen2-7b"), n_layers=2)
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device=CPU, dtype=F32)
    return cfg, params


def _factory(cfg, params, slots=2, max_len=MAX_LEN):
    return lambda: GenerationEngine(cfg, params, slots=slots,
                                    max_len=max_len, compute_dtype=F32,
                                    device=CPU)


def _requests(vocab, n, seed, lengths=(5, 9, 14), max_new=(4, 6)):
    """``n`` seeded (tenant, prompt, max_new) triples, tenant-major over
    ``WEIGHTS`` (a flood per tenant, as the smoke's drains submit)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tenant = list(WEIGHTS)[i * len(WEIGHTS) // n]
        length = int(lengths[int(rng.integers(len(lengths)))])
        out.append((tenant, rng.integers(0, vocab, length).astype(np.int32),
                    int(max_new[int(rng.integers(len(max_new)))])))
    return out


# ------------------------------------------------- control->data plane bridge

def test_fleet_bridge_replicas_metrics_and_scaledown(own_model):
    cfg, params = own_model
    fleet = ServingFleet(_factory(cfg, params), replicas=2,
                         scan_interval=0.05)
    fw = VirtualClusterFramework(num_nodes=2, scan_interval=0.0,
                                 heartbeat_interval=3600)
    fleet.attach(fw)
    with fw:
        plane_a = fw.add_tenant("alpha", weight=2)
        fleet.register_tenant(plane_a)
        fleet.register_tenant("beta")
        with pytest.raises(PermissionError):
            fleet.submit("ghost", np.zeros(4, np.int32))
        assert wait_for(lambda: fleet.live_replicas() == 2, timeout=20)
        assert wait_for(lambda: all(
            u.status.phase == "Ready"
            for u in fw.super_api.list("WorkUnit", SERVING_NS)), timeout=20)
        units = fw.super_api.list("WorkUnit", SERVING_NS)
        assert sorted(u.metadata.name for u in units) == \
            ["engine-0", "engine-1"]
        rng = np.random.default_rng(6)
        for _ in range(4):
            fleet.submit("alpha", rng.integers(0, cfg.vocab, 8),
                         max_new_tokens=4)
        for _ in range(2):
            fleet.submit("beta", rng.integers(0, cfg.vocab, 8),
                         max_new_tokens=4)
        done = fleet.wait_completed(6, timeout=60)
        assert len(done) == 6
        assert all(r.done and len(r.tokens) == 4 for r in done.values())
        snap = fw.metrics.snapshot()
        assert snap["summaries"]["serving_ttft_seconds{tenant=alpha}"][
            "count"] == 4
        assert snap["counters"]["serving_tokens_total{tenant=beta}"] == 8.0
        assert snap["counters"]["serving_requests_total{tenant=alpha}"] == 4.0
        assert snap["gauges"]["serving_live_replicas"] == 2.0
        assert snap["gauges"]["serving_pending_requests"] == 0.0
        fleet.resize(1)
        assert wait_for(lambda: fleet.live_replicas() == 1, timeout=20)
        assert wait_for(lambda: len(
            fw.super_api.list("WorkUnit", SERVING_NS)) == 1, timeout=20)
        assert fleet.retired == 1


def test_agent_stops_deleted_units():
    """A DELETED WorkUnit reaches the node agent, which releases the
    provider's resources (and forgets the key so a recreate can run)."""
    stopped = []

    class RecordingProvider(MockProvider):
        def stop(self, unit):
            stopped.append(unit.metadata.key)

    fw = VirtualClusterFramework(
        num_nodes=1, scan_interval=0.0, heartbeat_interval=3600,
        provider_factory=lambda name: RecordingProvider())
    with fw:
        unit = WorkUnit()
        unit.metadata.name = "w0"
        unit.metadata.namespace = "default"
        fw.super_api.create(unit)
        agent = next(iter(fw.agents.values()))
        assert wait_for(lambda: "default/w0" in agent._running_units)
        fw.super_api.delete("WorkUnit", "default", "w0")
        assert wait_for(lambda: stopped == ["default/w0"])
        assert "default/w0" not in agent._running_units


# ------------------------------------------------- fourth actuator

class _FakeFleet:
    """Stands in for ServingFleet in actuator unit tests."""

    def __init__(self, replicas=1, pending=0):
        self.desired_replicas = replicas
        self.pending_n = pending
        self.resizes = []
        self.scheduler = self

    def pending(self):
        return self.pending_n

    def live_replicas(self):
        return self.desired_replicas

    def resize(self, n):
        self.resizes.append(n)
        self.desired_replicas = n
        return n


def _scaler_rig():
    ex = CooperativeExecutor(pool_size=2, name="srv-as-test")
    api = APIServer("super")
    syncer = Syncer(api, downward_workers=2, upward_workers=2,
                    scan_interval=0.0, shards=1, executor=ex)
    syncer.register_tenant(TenantControlPlane("t0"), "uid-0")
    syncer.start()
    policy = ScalingPolicy(min_engine_replicas=1, max_engine_replicas=4,
                           engine_up_pending=2.0, engine_down_pending=0.25,
                           engine_up_ttft_s=10.0, hysteresis=2,
                           up_cooldown_s=0.1, down_cooldown_s=0.2,
                           window_s=1.5)
    return ex, syncer, Autoscaler(syncer, None, policy=policy,
                                  interval=3600)


def test_engine_actuator_scales_fleet_up_and_down():
    ex, syncer, scaler = _scaler_rig()
    fleet = _FakeFleet(replicas=1, pending=10)
    try:
        scaler.set_engine_fleet(fleet)
        # backlog of 10 pending on 1 replica breaches for 2 ticks -> x2
        scaler.tick(now=0.0)
        scaler.tick(now=0.05)
        assert fleet.resizes == [2]
        assert scaler.scale_events()[-1]["actuator"] == "engine_replicas"
        assert scaler.scale_events()[-1]["direction"] == "up"
        fleet.pending_n = 0
        t = 10.0
        while fleet.desired_replicas > 1 and t < 60.0:
            scaler.tick(now=t)
            t += 0.3
        assert fleet.desired_replicas == 1
        assert scaler.scale_events()[-1]["direction"] == "down"
    finally:
        syncer.stop()
        ex.shutdown()


def test_engine_actuator_absent_fleet_is_noop():
    ex, syncer, scaler = _scaler_rig()
    try:
        assert scaler.engine_fleet is None
        scaler.tick(now=0.0)
        scaler.tick(now=0.1)
        assert all(e["actuator"] != "engine_replicas"
                   for e in scaler.scale_events())
        assert scaler.state()["targets"]["engine_replicas"] is None
    finally:
        syncer.stop()
        ex.shutdown()


# ------------------------------------------------- the port against JAX

def _serve(core, fleet, reqs):
    """Serve ``reqs`` through ``fleet`` (2 replicas) attached to a fresh
    framework of ``core`` with tracing and metering on. Returns the
    finished requests by uid (uids run 1..n in submission order in both
    packages), the ``serving_*`` metrics, the serving span trees and the
    meter's totals."""
    fw = core.VirtualClusterFramework(num_nodes=2, scan_interval=0.0,
                                      heartbeat_interval=3600,
                                      tracing=True, metering=True)
    fleet.attach(fw)
    with fw:
        for tenant, w in WEIGHTS.items():
            fleet.register_tenant(fw.add_tenant(tenant, weight=w))
        assert wait_for(lambda: fleet.live_replicas() == 2, timeout=30)
        uids = [fleet.submit(t, p, max_new_tokens=n) for t, p, n in reqs]
        done = fleet.wait_completed(len(reqs), timeout=120)
        fleet.scan()      # flush the queue-wait stats into the summaries
        snap = fw.metrics.snapshot()
        spans = fw.tracer.spans()
        totals = fw.meter.totals()
    assert uids == list(range(1, len(reqs) + 1))
    metrics = {part: {k: v for k, v in snap[part].items()
                      if k.startswith("serving_")}
               for part in ("counters", "summaries", "gauges")}
    return done, metrics, _span_trees(spans), totals


def _span_trees(spans):
    """{uid: (tenant, tokens, [child span names])} for every
    ``serving.request`` root and its children."""
    by_id = {s["span_id"]: s for s in spans if s["name"] == "serving.request"}
    children = {}
    for s in spans:
        if s["parent_id"] in by_id:
            children.setdefault(s["parent_id"], []).append(
                (s["start"], s["name"], s["tenant"]))
    trees = {}
    for sid, root in by_id.items():
        kids = sorted(children.get(sid, []))
        assert all(tenant == root["tenant"] for _, _, tenant in kids)
        trees[root["attrs"]["uid"]] = (root["tenant"],
                                       root["attrs"]["tokens"],
                                       [name for _, name, _ in kids])
    return trees


@pytest.fixture(scope="module")
def both_fleets(jax_ref, model):
    """The same 12 requests through a 2-replica port fleet and a 2-replica
    JAX fleet, with tracing and metering on."""
    cfg, params = model
    reqs = _requests(cfg.vocab, 12, seed=3)
    port = _serve(tcore,
                  ServingFleet(_factory(cfg, params), replicas=2,
                               scan_interval=0.05), reqs)
    ref = _serve(jax_ref["core"],
                 jax_ref["Fleet"](jax_ref["factory"], replicas=2,
                                  scan_interval=0.05), reqs)
    return reqs, port, ref


def test_fleet_tokens_match_jax_oracle(jax_ref, both_fleets):
    """Each request's tokens from the 2-replica port fleet are the JAX
    oracle's for that prompt alone, whichever replica and admission group
    served it; so are the JAX fleet's."""
    reqs, (done, *_), (jdone, *_) = both_fleets
    for uid, (tenant, prompt, max_new) in enumerate(reqs, start=1):
        want = jax_ref["oracle"](prompt, max_new)
        assert done[uid].tokens == want, uid
        assert done[uid].tenant == tenant
        assert jdone[uid].tokens == want, uid


def test_fleet_metrics_match_jax_fleet(both_fleets):
    """Same ``serving_*`` counters and gauges, same summary counts but for
    the reference's ``serving_request_latency_seconds``, which the port
    does not keep (nothing read it)."""
    reqs, (_, metrics, *_), (_, jmetrics, *_) = both_fleets
    assert metrics["counters"] == jmetrics["counters"]
    assert metrics["gauges"] == jmetrics["gauges"]
    counts = {k: v["count"] for k, v in metrics["summaries"].items()}
    assert counts == {k: v["count"]
                      for k, v in jmetrics["summaries"].items()
                      if not k.startswith("serving_request_latency_seconds")}
    assert any(k.startswith("serving_request_latency_seconds")
               for k in jmetrics["summaries"])
    assert counts["serving_ttft_seconds"] == len(reqs)
    assert counts["serving_queue_wait_seconds{tenant=tenant-c}"] == \
        sum(1 for t, _, _ in reqs if t == "tenant-c")
    assert metrics["counters"]["serving_tokens_total"] == \
        sum(n for _, _, n in reqs)
    assert metrics["gauges"]["serving_live_replicas"] == 2.0


def test_fleet_spans_and_meter_keys_match_jax_fleet(both_fleets):
    """With ``tracing=True, metering=True`` every finished request leaves
    the same span tree (``serving.request`` and its queue-wait, admit,
    prefill and decode children) and the same meter keys per tenant in
    both packages, and the same request and token totals."""
    reqs, (_, _, trees, totals), (_, _, jtrees, jtotals) = both_fleets
    assert trees == jtrees
    assert sorted(trees) == list(range(1, len(reqs) + 1))
    for uid, (tenant, tokens, kids) in trees.items():
        assert kids == ["serving.queue_wait", "serving.admit",
                        "serving.prefill", "serving.decode"], uid
        assert (tenant, tokens) == (reqs[uid - 1][0], reqs[uid - 1][2])
    assert {t: sorted(v) for t, v in totals.items()} == \
        {t: sorted(v) for t, v in jtotals.items()}
    for tenant in WEIGHTS:
        for key in ("serving_requests", "tokens", "queue_items"):
            assert totals[tenant][key] == jtotals[tenant][key], (tenant, key)


def _lone(engine, reqs):
    """``reqs`` through a lone ``ContinuousBatcher`` with the fleet's WRR
    tenants: all submitted, then drained. Returns tokens in order."""
    sched = SlotScheduler()
    for tenant, w in WEIGHTS.items():
        sched.register_tenant(tenant, weight=w)
    batcher = ContinuousBatcher(engine, scheduler=sched)
    uids = [batcher.submit(p, max_new_tokens=n, tenant=t)
            for t, p, n in reqs]
    batcher.run_until_drained()
    return [batcher.completed[u].tokens for u in uids]


def _zero_to_one(fw, fleet, reqs, timeout=120):
    """With no replica live, submit ``reqs`` and resize to one: the
    replica's first ``take`` sees them all. Returns (tokens in order, the
    replica's engine)."""
    assert fleet.live_replicas() == 0
    uids = [fleet.submit(t, p, max_new_tokens=n) for t, p, n in reqs]
    fleet.resize(1)
    done = fleet.wait_completed(len(reqs), timeout=timeout)
    rep = fleet.replica(f"{SERVING_NS}/engine-0")
    return [done[u].tokens for u in uids], rep.engine


def test_zero_to_one_resize_matches_lone_batcher(own_model):
    """A 0 -> 1 resize under a backlog gives the lone batcher's tokens,
    admission groups and steps."""
    cfg, params = own_model
    reqs = _requests(cfg.vocab, 12, seed=4, lengths=(3, 7, 12, 20, 30))
    factory = _factory(cfg, params, slots=4)
    lone = factory()
    want = _lone(lone, reqs)
    fleet = ServingFleet(factory, replicas=0, scan_interval=0.05)
    fw = VirtualClusterFramework(num_nodes=2, scan_interval=0.0,
                                 heartbeat_interval=3600)
    fleet.attach(fw)
    with fw:
        for tenant, w in WEIGHTS.items():
            fleet.register_tenant(fw.add_tenant(tenant, weight=w))
        tokens, engine = _zero_to_one(fw, fleet, reqs)
    assert tokens == want
    assert engine.counters() == lone.counters()
    assert lone.admit_calls > 1 and lone.steps > 0


def test_retiring_replica_finishes_in_flight_requests(own_model):
    """Scale 2 -> 1 while the retiring replica (engine-1) holds requests
    in its slots: it admits nothing new, finishes them, and exits; the
    survivor serves the rest. No request is dropped."""
    cfg, params = own_model
    fleet = ServingFleet(_factory(cfg, params, slots=2, max_len=64),
                         replicas=2, scan_interval=0.05)
    fw = VirtualClusterFramework(num_nodes=2, scan_interval=0.0,
                                 heartbeat_interval=3600)
    fleet.attach(fw)
    rng = np.random.default_rng(9)
    with fw:
        fleet.register_tenant(fw.add_tenant("alpha"))
        assert wait_for(lambda: fleet.live_replicas() == 2, timeout=20)
        retiring = fleet.replica(f"{SERVING_NS}/engine-1")
        uids = [fleet.submit("alpha", rng.integers(0, cfg.vocab, 10),
                             max_new_tokens=40) for _ in range(8)]
        in_flight = []

        def busy():
            in_flight[:] = [r for r in retiring.engine.slot_req
                            if r is not None]
            return bool(in_flight)

        assert wait_for(busy, timeout=30)
        fleet.resize(1)
        done = fleet.wait_completed(len(uids), timeout=120)
        retiring.join(timeout=30)
        assert not retiring._thread.is_alive()
        assert fleet.retired == 1 and fleet.live_replicas() == 1
        assert wait_for(lambda: [u.metadata.name for u in fw.super_api.list(
            "WorkUnit", SERVING_NS)] == ["engine-0"], timeout=20)
    assert sorted(done) == sorted(uids)
    assert all(r.done and len(r.tokens) == 40 for r in done.values())
    assert in_flight and all(done[r.uid] is r for r in in_flight)


# ------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _expected_launches(cfg, engine):
    """One engine's kernel launches since it was built: one per attention
    layer per admit call and per decode step, plus its capture's warm-up
    step (the launches one replay records)."""
    attn = cfg.n_blocks * sum(cfg.layer_pattern.count(k) for k in "gl")
    warm = engine._graph_launches.get(fd_kernel.KERNEL, 0)
    return {"flash_attention": attn * engine.admit_calls,
            "flash_decode": attn * engine.steps + warm}


@pytest.mark.cuda
def test_fleet_on_the_card(cuda):
    """A graphed fleet of reduced qwen2-7b on the card, started at 2
    replicas as the reference's fleet test starts: both replicas spawn at
    once on pool threads of the framework's executor (their captures take
    turns under ``CAPTURE_LOCK``), while the main thread syncs the device
    under the lock without waiting for their units' ``Ready``. Requests of
    distinct buckets, so one row an admit call whichever replica takes
    them, get a lone graphed engine's tokens. Then, under load, a third
    replica is built (its decode graph captured) on a pool thread while the
    others step. Each kernel's launches over the fleet's run equal the sum
    over its replicas."""
    cfg = reduced(get_config("qwen2-7b"), n_layers=2)
    params = init_params(cfg, generator=torch.Generator(device=cuda).manual_seed(7),
                         device=cuda, dtype=torch.bfloat16)
    # buckets 8, 16, 32 and 47: one request a bucket
    rng = np.random.default_rng(5)
    reqs = [(list(WEIGHTS)[i % 3], rng.integers(0, cfg.vocab, n), 6)
            for i, n in enumerate((5, 12, 20, 40))]
    builds, steps = [], []

    def factory():
        t0 = time.monotonic()
        engine = GenerationEngine(cfg, params, slots=4, max_len=MAX_LEN,
                                  device=cuda)
        builds.append((engine, threading.current_thread().name, t0,
                       time.monotonic()))
        step = engine.step

        def timed_step():
            steps.append((engine, time.monotonic()))
            return step()

        engine.step = timed_step
        return engine

    lone = GenerationEngine(cfg, params, slots=4, max_len=MAX_LEN,
                            device=cuda)
    assert lone._graph is not None and lone._graph_admit
    want = _lone(lone, reqs)
    assert lone.admit_calls == len(reqs)
    fleet = ServingFleet(factory, replicas=2, scan_interval=0.05)
    fw = VirtualClusterFramework(num_nodes=2, scan_interval=0.0,
                                 heartbeat_interval=3600)
    fleet.attach(fw)
    for k in KERNELS:
        k.launches = 0
    with fw:
        for tenant, w in WEIGHTS.items():
            fleet.register_tenant(fw.add_tenant(tenant, weight=w))
        syncs = 0
        while fleet.live_replicas() < 2 or syncs == 0:
            with CAPTURE_LOCK:      # both replicas may be capturing now
                torch.cuda.synchronize()
            syncs += 1
            time.sleep(0.001)
        uids = [fleet.submit(t, p, max_new_tokens=n) for t, p, n in reqs]
        done = fleet.wait_completed(len(uids), timeout=120)
        assert [done[u].tokens for u in uids] == want
        assert wait_for(lambda: [u.status.phase for u in fw.super_api.list(
            "WorkUnit", SERVING_NS)] == ["Ready", "Ready"], timeout=120)
        # keep both busy (40 requests of 32 tokens on 8 slots), then grow:
        # engine-2 is built meanwhile. A first round of the same load lets
        # each replica capture the admission shapes it meets (a shape met
        # while engine-2 captures stays eager: ``captures_skipped``); then,
        # since the two may drain 40 requests before the resize reaches a
        # node agent, requests keep coming until engine-2 is built (at most
        # 2,000)
        rng = np.random.default_rng(6)

        def submit():
            more.append(fleet.submit("tenant-a", rng.integers(0, cfg.vocab, 8),
                                     max_new_tokens=32))
        more = []
        for _ in range(40):
            submit()
        fleet.wait_completed(len(uids) + len(more), timeout=300)
        for _ in range(40):
            submit()
        assert wait_for(lambda: sum(b[0].active_slots() for b in builds) > 0,
                        timeout=60)
        t_resize = time.monotonic()
        fleet.resize(3)
        while len(builds) < 3 and len(more) < 2000:
            submit()
            time.sleep(0.002)
        done = fleet.wait_completed(len(uids) + len(more), timeout=300)
        assert wait_for(lambda: fleet.live_replicas() == 3, timeout=120)
        with CAPTURE_LOCK:
            torch.cuda.synchronize()
        launches = {k.name: k.launches for k in KERNELS}
    assert all(done[u].done and len(done[u].tokens) == 32 for u in more)
    assert len(builds) == 3
    assert all(name.startswith("vc-exec") for _, name, _, _ in builds), builds
    third, _, t0, t1 = builds[2]
    others = [t for e, t in steps if e is not third]
    assert any(t0 <= t <= t1 for t in others), (
        "no replica stepped while engine-2 was built: resize at "
        f"{t_resize:.4f}, build [{t0:.4f}, {t1:.4f}], other replicas' last "
        f"step before it {max((t for t in others if t < t0), default=None)}, "
        f"first after it {min((t for t in others if t > t1), default=None)}, "
        f"{len(more)} requests")
    want_launches = {"flash_attention": 0, "flash_decode": 0,
                     "rwkv6_scan": 0, "mamba_scan": 0, "grouped_gemm": 0}
    for engine, _, _, _ in builds:
        for name, n in _expected_launches(cfg, engine).items():
            want_launches[name] += n
    assert launches == want_launches


@pytest.mark.cuda
def test_zero_to_one_resize_matches_lone_on_the_card(cuda):
    """A 0 -> 1 resize under a backlog on the card gives a lone graphed
    engine's tokens and counters (admission groups, admit calls, steps),
    admission graphs included: the replica's first ``take`` sees every
    request, as ``pump`` does."""
    cfg = reduced(get_config("qwen2-7b"), n_layers=2)
    params = init_params(cfg, generator=torch.Generator(device=cuda).manual_seed(7),
                         device=cuda, dtype=torch.bfloat16)
    reqs = _requests(cfg.vocab, 12, seed=5, lengths=(3, 7, 12, 20, 30))

    def factory():
        return GenerationEngine(cfg, params, slots=4, max_len=MAX_LEN,
                                device=cuda)

    lone = factory()
    want = _lone(lone, reqs)
    fleet = ServingFleet(factory, replicas=0, scan_interval=0.05)
    fw = VirtualClusterFramework(num_nodes=2, scan_interval=0.0,
                                 heartbeat_interval=3600)
    fleet.attach(fw)
    with fw:
        for tenant, w in WEIGHTS.items():
            fleet.register_tenant(fw.add_tenant(tenant, weight=w))
        tokens, first = _zero_to_one(fw, fleet, reqs)
    assert tokens == want
    counts = [{k: v for k, v in e.counters().items() if k != "capture_s"}
              for e in (first, lone)]       # capture_s: a time, not a count
    assert counts[0] == counts[1]
    assert first._admit_graphs.keys() == lone._admit_graphs.keys()


@pytest.mark.cuda
def test_fleet_grows_zero_to_three_in_one_resize(cuda):
    """0 -> 3 replicas in one resize under a backlog of one request per
    bucket: the three engines are built at once on pool threads (their
    captures in turn) while the main thread syncs the device under the
    capture lock; all three units reach ``Ready``, and each request's
    tokens are a lone graphed engine's."""
    cfg = reduced(get_config("qwen2-7b"), n_layers=2)
    params = init_params(cfg, generator=torch.Generator(device=cuda).manual_seed(8),
                         device=cuda, dtype=torch.bfloat16)
    rng = np.random.default_rng(9)
    reqs = [(list(WEIGHTS)[i % 3], rng.integers(0, cfg.vocab, n), 6)
            for i, n in enumerate((5, 12, 20, 40))]

    def factory():
        return GenerationEngine(cfg, params, slots=4, max_len=MAX_LEN,
                                device=cuda)

    want = _lone(factory(), reqs)
    fleet = ServingFleet(factory, replicas=0, scan_interval=0.05)
    fw = VirtualClusterFramework(num_nodes=2, scan_interval=0.0,
                                 heartbeat_interval=3600)
    fleet.attach(fw)
    with fw:
        for tenant, w in WEIGHTS.items():
            fleet.register_tenant(fw.add_tenant(tenant, weight=w))
        uids = [fleet.submit(t, p, max_new_tokens=n) for t, p, n in reqs]
        fleet.resize(3)
        while fleet.live_replicas() < 3:
            with CAPTURE_LOCK:
                torch.cuda.synchronize()
            time.sleep(0.001)
        done = fleet.wait_completed(len(uids), timeout=120)
        assert wait_for(lambda: [u.status.phase for u in fw.super_api.list(
            "WorkUnit", SERVING_NS)] == ["Ready"] * 3, timeout=120)
    assert [done[u].tokens for u in uids] == want
    assert fleet.spawned == 3


def test_example_serves_on_the_cpu():
    """``examples/serve_multitenant_torch.py --device cpu`` serves both
    tenants through the fleet and ends with ``done``."""
    repo = Path(__file__).resolve().parents[1]
    res = subprocess.run(
        [sys.executable, str(repo / "examples" / "serve_multitenant_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(repo / "src")))
    assert res.returncode == 0, res.stderr
    lines = res.stdout.splitlines()
    assert lines[-1] == "done"
    assert any("metrics[steady]: ttft_count=4 tokens=32" in line
               for line in lines), res.stdout
