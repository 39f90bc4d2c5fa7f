"""Admission as CUDA graphs (the other half of the reference's
``_compiled``), and the process's one capture lock.

On the CPU, for each attention-only served arch (reduced, 2 layers; the
encoder-decoder's slot cache holds zero cross K/V of max_len rows;
weights from the JAX package through ``params_from_jax``, fp32; gemma2's
window cut to 8 positions so that it binds at these lengths):
- the staged admit body ``_admit_staged``, which reads one flat static
  buffer and writes the first tokens into the engine's ``_first`` buffer
  (what an admission graph captures), leaves the same slot state and first
  tokens as ``_admit`` called on its own tensors, bit for bit (and so for
  jamba-v0.1, 8 layers, whose Mamba layers take right-padded prompts);
- admission through the engine's graph logic, with a stand-in capture whose
  replay runs the captured body (nothing captures on the CPU): a shape's
  first call runs eagerly and is captured after, later calls of the shape
  replay from the static buffer, and the slot state after each admission
  and the greedy tokens are the JAX engine's;
- RWKV engines ("r", exact-length buckets) admit without graphs;
- threads entering the capture section, and threads that hold the lock for
  a device-wide sync, never overlap (stand-in graph, streams and body);
- an engine meeting new shapes while another thread holds the lock admits
  them eagerly, skips their captures and keeps stepping, and captures
  them on a later call.

On the card (marker ``cuda``; skipped without one): graphed against eager
admission (both with the graphed step), tokens and launch counts equal and
the second drain all replays; the admit body under
``torch.cuda.set_sync_debug_mode("error")``; RWKV engines build no
admission graph; the concurrent-capture fault as a regression test: two
graphed engines built and driven at once on two threads, while the main
thread syncs the device and releases the allocator's cache under the lock;
and a live engine meeting new shapes while another thread builds an
engine under the lock, which must keep stepping.

Tolerances: tokens, slot lengths, budgets, active flags and first tokens
are compared exactly; the bf16 K/V cache against the JAX engine's to one
bf16 ulp (rtol 2**-7), as fp32 compute rounds to bf16 in both.
"""
import contextlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.device import CAPTURE_LOCK
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.models import convert, init_params
from repro_torch.serving import GenerationEngine, Request
from repro_torch.serving import engine as engine_mod

F32 = torch.float32
MAX_LEN = 40
ATTN = ["qwen2-7b", "gemma2-9b", "yi-9b", "qwen2.5-14b", "olmoe-1b-7b",
        "qwen3-moe-30b-a3b", "internvl2-2b", "seamless-m4t-large-v2"]
# the patterns whose admission pads to buckets and is graphed on the card
PADDED = ATTN + ["jamba-v0.1-52b"]
RECURRENT = ["rwkv6-7b"]
STATE = ("_slot_lengths", "_budget", "_active", "_last")
# two rounds of four requests on four slots; the same lengths and budgets
# in both, so the second round's admission shapes are the first's
LENGTHS = (5, 12, 9, 3)
MAX_NEW = (4, 1, 6, 3)


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package (skips where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models import init_params as j_init_params
    from repro.serving import GenerationEngine as JEngine
    from repro.serving import Request as JRequest
    return dict(jax=jax, jnp=jnp, get_config=j_get_config,
                reduced=j_reduced, init_params=j_init_params,
                Engine=JEngine, Request=JRequest)


def _cfg(arch, get=get_config, red=reduced):
    kw = {"n_layers": 8} if arch.startswith("jamba") else {"n_layers": 2}
    if arch == "gemma2-9b":
        kw["sliding_window"] = 8       # binds at these prompt lengths
    return red(get(arch), **kw)


def _models(arch, ref, seed=0):
    """The port's and the reference's configs of ``arch``, the reference's
    seeded weights and the same weights in the port (fp32, CPU)."""
    jax = ref["jax"]
    jcfg = _cfg(arch, ref["get_config"], ref["reduced"])
    jparams = ref["init_params"](jax.random.PRNGKey(seed), jcfg)
    cfg = _cfg(arch)
    np_tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jparams)
    params = convert.params_from_jax(np_tree, cfg, device="cpu",
                                     compute_dtype=F32)
    return cfg, jcfg, params, jparams


def _engine(cfg, params, **kw):
    return GenerationEngine(cfg, params, slots=4, max_len=MAX_LEN,
                            compute_dtype=F32, device="cpu", **kw)


def _round(vocab, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in LENGTHS]


def _admit_and_drain(engine, make, prompts, uid0=0):
    """Admit ``prompts`` (budgets ``MAX_NEW``) in one call, then step until
    every slot is free. Returns the requests."""
    reqs = [make(uid0 + i, p, n) for i, (p, n) in
            enumerate(zip(prompts, MAX_NEW))]
    engine.admit_many(reqs)
    while engine.active_slots():
        engine.step()
    return reqs


def _assert_slot_state(eng, jeng):
    for name in STATE:
        np.testing.assert_array_equal(getattr(eng, name).numpy(),
                                      np.asarray(getattr(jeng, name)),
                                      err_msg=name)
    for sub, leaves in jeng.cache.items():
        for leaf, c in leaves.items():
            np.testing.assert_allclose(
                eng.cache[sub][leaf].float().numpy(),
                np.asarray(c, np.float32), atol=1e-6, rtol=2 ** -7,
                err_msg=f"{sub}/{leaf}")


# ------------------------------------------------------------ the CPU

@pytest.mark.parametrize("arch", PADDED)
def test_staged_admit_body_matches_eager_admit(jax_ref, arch):
    """``_admit_staged`` on a static flat buffer against ``_admit`` on its
    own tensors, two engines on the same weights: the same first tokens,
    slot state and cache, bit for bit; the first tokens land in the
    engine's own ``_first`` buffer."""
    cfg, _, params, _ = _models(arch, jax_ref)
    k, pad_len = 3, 16
    lens = np.array([5, 12, 9], np.int32)
    idx = np.array([2, 0, 3], np.int32)
    max_new = np.array([4, 1, 6], np.int32)
    rng = np.random.default_rng(1)
    prompts = np.zeros((k, pad_len), np.int32)
    for j, n in enumerate(lens):
        prompts[j, :n] = rng.integers(0, cfg.vocab, n)
    eager, staged = _engine(cfg, params), _engine(cfg, params)
    want = eager._admit(torch.from_numpy(prompts),
                        torch.from_numpy(idx).long(),
                        torch.from_numpy(lens), torch.from_numpy(max_new))
    static = torch.zeros((k * pad_len + 3 * k,), dtype=torch.int32)
    static.copy_(torch.from_numpy(
        np.concatenate([prompts.reshape(-1), idx, lens, max_new])))
    first_ptr = staged._first.data_ptr()
    got = staged._admit_staged(static, k, pad_len)
    assert got.data_ptr() == first_ptr and got.shape == (k,)
    assert torch.equal(got, want)
    for name in STATE:
        assert torch.equal(getattr(staged, name), getattr(eager, name)), name
    for sub, leaves in eager.cache.items():
        for leaf, c in leaves.items():
            assert torch.equal(staged.cache[sub][leaf], c), (sub, leaf)
    assert int(staged._active.sum()) == 2      # max_new 1 finished at once


class _NullStream:
    """Stands in for a CUDA stream on the CPU."""
    device = torch.device("cpu")

    def wait_stream(self, other):
        pass


class _ReplayingGraph:
    """Stands in for a captured graph: ``replay()`` runs the body."""

    def __init__(self, body):
        self.body = body
        self.replays = 0

    def replay(self):
        self.replays += 1
        self.body()


@pytest.fixture
def stand_in_capture(monkeypatch):
    """``engine._capture_graph`` and the streams it and the engine use,
    replaced for the CPU: a capture runs its warm-up and returns a graph
    whose replay runs the body. Yields the graphs captured."""
    graphs = []

    def capture(body, stream, *, pool=None, warmup=None):
        if warmup is not None:
            warmup()
        graphs.append(_ReplayingGraph(body))
        return graphs[-1], {}

    monkeypatch.setattr(engine_mod, "_capture_graph", capture)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _NullStream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    yield graphs


def _graph_admitting(engine):
    """A CPU engine set to admit as a graphed card engine of an
    attention-only pattern does."""
    engine._graph_admit = True
    engine._capture_stream = _NullStream()
    engine._admit_pool = None
    return engine


@pytest.mark.parametrize("arch", ATTN)
def test_graph_admission_gives_jax_tokens_and_slot_state(
        jax_ref, stand_in_capture, arch):
    """Two rounds through the engine's graph-admission logic: the first
    round's calls run eagerly and capture their (rows, bucket) shapes, the
    second round's replay them from their static buffers. After each
    admission the slot state is the JAX engine's, and each round's greedy
    tokens are its too; ``host_syncs == admit_calls + steps``."""
    cfg, jcfg, params, jparams = _models(arch, jax_ref)
    jnp = jax_ref["jnp"]
    eng = _graph_admitting(_engine(cfg, params))
    jeng = jax_ref["Engine"](jcfg, jparams, slots=4, max_len=MAX_LEN,
                             compute_dtype=jnp.float32)
    shapes = {(2, 8), (2, 16)}          # lengths 5, 3 and 12, 9
    for rnd in range(2):
        prompts = _round(cfg.vocab, seed=10 + rnd)
        reqs = [Request(rnd * 10 + i, p, n)
                for i, (p, n) in enumerate(zip(prompts, MAX_NEW))]
        jreqs = [jax_ref["Request"](rnd * 10 + i, p, n)
                 for i, (p, n) in enumerate(zip(prompts, MAX_NEW))]
        eng.admit_many(reqs)
        jeng.admit_many(jreqs)
        _assert_slot_state(eng, jeng)
        assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
        assert set(eng._admit_graphs) == shapes
        assert eng.admit_replays == 2 * rnd
        while eng.active_slots():
            eng.step()
        while jeng.active_slots():
            jeng.step()
        assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
        assert [len(r.tokens) for r in reqs] == list(MAX_NEW)
    assert len(stand_in_capture) == 2
    assert sorted(g.replays for g in stand_in_capture) == [1, 1]
    assert eng.host_syncs == eng.admit_calls + eng.steps
    assert eng.admit_calls == 4


def _hold_capture_lock(work=lambda: None):
    """A thread that takes ``CAPTURE_LOCK``, runs ``work()`` under it (a
    replica's build, say) and holds it until released. Returns (thread,
    its taken event, its release event, its errors)."""
    taken, release, errors = threading.Event(), threading.Event(), []

    def hold():
        with CAPTURE_LOCK:
            taken.set()
            try:
                work()
            except Exception as e:      # reported by the main thread
                errors.append(e)
            release.wait(timeout=120)
    thread = threading.Thread(target=hold, name="lock-holder")
    thread.start()
    assert taken.wait(timeout=60)
    return thread, release, errors


def _drive_round(engine, prompts, uid0, timeout=120):
    """``_admit_and_drain`` on a thread of its own, which must end within
    ``timeout`` (an admission that waited on the capture lock would not)."""
    out = {}
    thread = threading.Thread(target=lambda: out.update(
        reqs=_admit_and_drain(engine, Request, prompts, uid0)))
    thread.start()
    thread.join(timeout=timeout)
    assert not thread.is_alive(), "the round waited on another's capture"
    return [r.tokens for r in out["reqs"]]


def test_admission_capture_never_waits_on_another_thread(stand_in_capture):
    """While another thread holds ``CAPTURE_LOCK``, a graph-admitting
    engine that meets new admission shapes admits them eagerly, skips their
    captures (``captures_skipped``) and keeps stepping; once the lock is
    free, the next call of each shape runs eagerly again and captures it,
    and the call after replays it. Tokens equal an eager engine's in every
    round."""
    cfg = _cfg("qwen2-7b")
    params = init_params(cfg, generator=torch.Generator().manual_seed(1),
                         device="cpu", dtype=F32)
    eng, twin = _graph_admitting(_engine(cfg, params)), _engine(cfg, params)
    rounds = [_round(cfg.vocab, seed=40)] * 3
    want = [[r.tokens for r in _admit_and_drain(twin, Request, p, 10 * i)]
            for i, p in enumerate(rounds)]
    holder, release, errors = _hold_capture_lock()
    try:
        assert _drive_round(eng, rounds[0], 0) == want[0]
        assert eng.captures_skipped == 2 and eng._admit_graphs == {}
        assert stand_in_capture == [] and eng.steps > 0
    finally:
        release.set()
        holder.join(timeout=60)
    assert not holder.is_alive() and not errors
    assert _drive_round(eng, rounds[1], 10) == want[1]
    assert set(eng._admit_graphs) == {(2, 8), (2, 16)}
    assert eng.admit_replays == 0
    assert _drive_round(eng, rounds[2], 20) == want[2]
    assert eng.admit_replays == 2
    assert eng.counters()["captures_skipped"] == 2
    assert eng.host_syncs == eng.admit_calls + eng.steps


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_engines_build_no_admit_graph(stand_in_capture, arch):
    """Exact-length buckets would make a graph per request: an "r"
    engine admits eagerly whatever the capture would do (here the stand-in
    records every capture, and none is made), and so does every engine on
    the CPU."""
    cfg = _cfg(arch)
    params = init_params(cfg, generator=torch.Generator().manual_seed(1),
                         device="cpu", dtype=F32)
    eng = _engine(cfg, params)
    assert eng._exact_buckets and not eng._graph_admit
    for rnd in range(2):
        _admit_and_drain(eng, Request, _round(cfg.vocab, seed=rnd), 10 * rnd)
    assert stand_in_capture == [] and eng._admit_graphs == {}
    assert eng.admit_replays == 0 and eng.admit_calls == 8
    for arch_ in ATTN:
        assert not _engine(_cfg(arch_), init_params(
            _cfg(arch_), generator=torch.Generator().manual_seed(1),
            device="cpu", dtype=F32))._graph_admit


def test_capture_section_admits_one_thread_at_a_time(monkeypatch):
    """Eight threads run five captures each through
    ``engine._capture_graph`` (stand-in graph, streams and body: the
    section's code is the engine's), while two more threads hold
    ``CAPTURE_LOCK`` for a stand-in device-wide sync. No two of those
    sections overlap in time, from a capture's warm-up to its end (each
    span's end is read inside the section: read after ``_capture_graph``
    returns, it could come after the next holder's start)."""
    spans, errors = [], []
    spans_lock = threading.Lock()
    ends = threading.local()

    class StandInGraph:
        def capture_begin(self, pool=None, capture_error_mode="global"):
            assert capture_error_mode == "thread_local"

        def capture_end(self):
            time.sleep(0.0005)
            ends.t = time.perf_counter()

    monkeypatch.setattr(torch.cuda, "CUDAGraph", StandInGraph)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda stream: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: _NullStream())

    def note(start, end=None):
        end = time.perf_counter() if end is None else end
        with spans_lock:
            spans.append((start, end, threading.current_thread().name))

    def capturer():
        try:
            for _ in range(5):
                t = {}

                def warm():
                    t["start"] = time.perf_counter()
                    time.sleep(0.0005)

                graph, launches = engine_mod._capture_graph(
                    lambda: time.sleep(0.0005), _NullStream(), warmup=warm)
                note(t["start"], ends.t)
                assert isinstance(graph, StandInGraph) and launches == {}
        except Exception as e:          # reported by the main thread
            errors.append(e)

    def syncer():
        for _ in range(10):
            with CAPTURE_LOCK:
                start = time.perf_counter()
                time.sleep(0.0005)
                note(start)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = ([threading.Thread(target=capturer, name=f"capture-{i}")
                    for i in range(8)]
                   + [threading.Thread(target=syncer, name=f"sync-{i}")
                      for i in range(2)])
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    assert len(spans) == 8 * 5 + 2 * 10
    spans.sort()
    for (s0, e0, n0), (s1, e1, n1) in zip(spans, spans[1:]):
        assert s1 >= e0, f"{n0} [{s0}, {e0}] overlaps {n1} [{s1}, {e1}]"


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _card_model(arch, cuda):
    cfg = _cfg(arch)
    params = init_params(cfg, generator=torch.Generator(device=cuda)
                         .manual_seed(5), device=cuda, dtype=torch.bfloat16)
    return cfg, params


def _attn_layers(cfg):
    return cfg.n_blocks * sum(cfg.layer_pattern.count(k) for k in "gl")


def _counted_round(engine, prompts, uid0):
    """One round (``_admit_and_drain``) with the attention kernels' counts
    set to 0 before and read after; returns (tokens, launches, the
    engine's admit calls and steps in the round)."""
    before = engine.counters()
    for k in (fa_kernel.KERNEL, fd_kernel.KERNEL):
        k.launches = 0
    reqs = _admit_and_drain(engine, Request, prompts, uid0)
    torch.cuda.synchronize()
    after = engine.counters()
    d = {key: after[key] - before[key] for key in after}
    assert d["host_syncs"] == d["admit_calls"] + d["steps"], d
    return ([r.tokens for r in reqs],
            (fa_kernel.KERNEL.launches, fd_kernel.KERNEL.launches),
            (d["admit_calls"], d["steps"]))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", PADDED)
def test_graphed_admission_matches_eager_admission(cuda, arch):
    """Two graphed engines on one set of bf16 weights, one of them with its
    graph admission cleared (both keep the graphed step), two rounds each:
    identical greedy tokens and launch counts, one attention launch per
    attention layer per admit call and per step (and for the
    encoder-decoder one cross-attention launch more); the graphed engine
    captures each shape of the first round once and replays every call of
    the second."""
    cfg, params = _card_model(arch, cuda)
    attn = _attn_layers(cfg)
    cross = attn if cfg.is_encdec else 0     # one more a call and a step
    rounds = [_round(cfg.vocab, seed=20 + r) for r in range(2)]
    got = {}
    for graph_admit in (True, False):
        eng = GenerationEngine(cfg, params, slots=4, max_len=MAX_LEN,
                               device=cuda)
        assert eng._graph is not None and eng._graph_admit
        eng._graph_admit = graph_admit
        got[graph_admit] = []
        for r, prompts in enumerate(rounds):
            replays = eng.admit_replays
            tokens, launches, (admits, steps) = _counted_round(
                eng, prompts, 10 * r)
            assert launches == (attn * admits + cross * (admits + steps),
                                attn * steps)
            assert eng.admit_replays - replays == (
                admits if graph_admit and r == 1 else 0)
            got[graph_admit].append((tokens, launches))
        assert len(eng._admit_graphs) == (2 if graph_admit else 0)
    assert got[True] == got[False]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", PADDED)
def test_admit_body_makes_no_host_sync(cuda, arch):
    """``_admit_staged``, the body an admission graph holds, under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at an op that
    syncs with the host; its first tokens equal those of ``_admit`` on the
    same inputs in a second engine."""
    cfg, params = _card_model(arch, cuda)
    engines = [GenerationEngine(cfg, params, slots=4, max_len=MAX_LEN,
                                device=cuda, cuda_graph=False)
               for _ in range(2)]
    rng = np.random.default_rng(3)
    k, pad_len = 2, 16
    lens = np.array([12, 7], np.int32)
    prompts = np.zeros((k, pad_len), np.int32)
    for j, n in enumerate(lens):
        prompts[j, :n] = rng.integers(0, cfg.vocab, n)
    idx, max_new = np.array([1, 3], np.int32), np.array([5, 2], np.int32)
    buf = torch.from_numpy(np.concatenate(
        [prompts.reshape(-1), idx, lens, max_new])).to(cuda)
    want = engines[1]._admit(*(torch.from_numpy(a).to(cuda) for a in
                               (prompts, idx.astype(np.int64), lens,
                                max_new)))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = engines[0]._admit_staged(buf, k, pad_len)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_engines_admit_eagerly_on_the_card(cuda, arch):
    """A graphed "r" engine replays its decode graph but admits
    eagerly: no admission graph after two rounds of the same shapes."""
    cfg, params = _card_model(arch, cuda)
    eng = GenerationEngine(cfg, params, slots=4, max_len=MAX_LEN,
                           device=cuda)
    assert eng._graph is not None and not eng._graph_admit
    for r in range(2):
        _counted_round(eng, _round(cfg.vocab, seed=r), 10 * r)
    assert eng._admit_graphs == {} and eng.admit_replays == 0


@pytest.mark.cuda
def test_live_engine_keeps_stepping_while_another_builds(cuda):
    """The open fault of a live replica that met a new admission shape
    while another replica was built, as a regression test: a thread takes
    ``CAPTURE_LOCK``, builds a graphed engine under it (its decode graph's
    capture) and holds the lock until released. Meanwhile a live graphed
    engine drives a round of new shapes: it must finish the round (admit
    eagerly, skip both captures, step) before the lock is released, with a
    lone engine's tokens. Then the next round captures both shapes and the
    one after replays them, with the same tokens."""
    cfg, params = _card_model("qwen2-7b", cuda)
    rounds = [_round(cfg.vocab, seed=50)] * 3

    def build():
        return GenerationEngine(cfg, params, slots=4, max_len=MAX_LEN,
                                device=cuda)

    lone = build()
    want = [[r.tokens for r in _admit_and_drain(lone, Request, p, 10 * i)]
            for i, p in enumerate(rounds)]
    live = build()
    built = []
    holder, release, errors = _hold_capture_lock(lambda: built.append(build()))
    try:
        assert _drive_round(live, rounds[0], 0) == want[0]
        assert holder.is_alive()          # the lock was held all along
        assert live.captures_skipped == 2 and live._admit_graphs == {}
    finally:
        release.set()
        holder.join(timeout=120)
    assert not holder.is_alive() and not errors
    assert built and built[0]._graph is not None
    assert _drive_round(live, rounds[1], 10) == want[1]
    assert set(live._admit_graphs) == {(2, 8), (2, 16)}
    assert _drive_round(live, rounds[2], 20) == want[2]
    assert live.admit_replays == 2 and live.captures_skipped == 2


@pytest.mark.cuda
def test_two_graphed_engines_built_at_once_on_two_threads(cuda):
    """The concurrent-capture fault as a regression test. In each of four
    trials two threads, released together, each build a graphed engine
    (its decode graph's capture) and drive two rounds (capturing its
    admission graphs on its own thread and replaying them, or, where
    another thread holds ``CAPTURE_LOCK``, leaving a shape eager for a
    later call), while the main thread syncs the device and releases the
    allocator's cache in a loop under the lock. Every build and drive
    succeeds, each engine's tokens equal a lone engine's, and each
    eager call of a shape not yet captured either captured it or counted
    a skipped capture."""
    cfg, params = _card_model("qwen2-7b", cuda)
    rounds = [_round(cfg.vocab, seed=30 + r) for r in range(2)]

    def serve(engine):
        return [[r.tokens for r in _admit_and_drain(engine, Request, p,
                                                    10 * i)]
                for i, p in enumerate(rounds)]

    def build():
        return GenerationEngine(cfg, params, slots=4, max_len=MAX_LEN,
                                device=cuda)

    want = serve(build())
    for trial in range(4):
        barrier = threading.Barrier(2)
        got, errors = {}, []

        def run(i):
            try:
                barrier.wait(timeout=60)
                engine = build()
                got[i] = (serve(engine), engine)
            except Exception as e:      # reported by the main thread
                errors.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        syncs = 0
        while any(t.is_alive() for t in threads):
            with CAPTURE_LOCK:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            syncs += 1
            time.sleep(0.001)
        for t in threads:
            t.join(timeout=300)
            assert not t.is_alive()
        assert not errors, (trial, errors)
        assert syncs > 0
        for i in range(2):
            tokens, engine = got[i]
            assert tokens == want, (trial, i)
            assert engine._graph is not None
            assert engine.admit_calls == 4
            assert (len(engine._admit_graphs) + engine.captures_skipped
                    == engine.admit_calls - engine.admit_replays)
