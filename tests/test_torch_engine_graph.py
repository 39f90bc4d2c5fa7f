"""The engine's decode step as one CUDA graph (the port of the reference's
``_compiled``): what the graph needs from the code it captures, held on the
CPU, and the graph itself on the card.

On the CPU:
- the MoE routing, which no longer reads anything back to the host, gives
  the (expert, token, gate, rank, kept) of the reference's routing (written
  out with ``jnp`` from ``repro.models.moe._moe_local``), capacity drops
  included, and ``_moe_local`` matches the reference's at fp32;
- the step writes every result into the engine's static buffers (their
  ``data_ptr`` stays put through admissions and steps, slot reuse
  included) and greedy tokens stay identical to the JAX engine's;
- a CPU engine never captures, and asking it for a graph raises;
- ``record_launches`` diverts the current thread's launch counts only.

On the card (marker ``cuda``; skipped without one): the routing under
``torch.cuda.set_sync_debug_mode("error")``, graphed against eager greedy
tokens, the launch counts across replays, and a capture in one thread
while another engine steps in a second thread.

Tolerances: gates and MoE outputs are fp32 sums in another order than
XLA's, atol 1e-6 / rtol 1e-5 for a softmax of one product and atol 1e-5 /
rtol 1e-4 for the expert GLU (``tests/test_torch_models.py``'s MoE
tolerance). Tokens and ranks are compared exactly.
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_decode import kernel as fd_kernel
from repro_torch.kernels.mamba_scan import kernel as ms_kernel
from repro_torch.kernels.rwkv6_scan import kernel as rs_kernel
from repro_torch.models import init_params
from repro_torch.models import moe as tmoe
from repro_torch.serving import GenerationEngine, Request

F32 = torch.float32
MAX_LEN = 40
SERVED = ["qwen2-7b", "rwkv6-7b", "jamba-v0.1-52b", "internvl2-2b"]
ENCDEC = "seamless-m4t-large-v2"
# the published expert counts and top-k at reduced widths
MOE = {"olmoe-1b-7b": {}, "qwen3-moe-30b-a3b": {},
       "jamba-v0.1-52b": {"n_layers": 8}}


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package (skips where JAX is not installed)."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs import get_config as j_get_config
    from repro.configs import reduced as j_reduced
    from repro.models import moe as jmoe
    from repro.serving import GenerationEngine as JEngine
    from repro.serving import Request as JRequest
    return dict(jax=jax, jnp=jnp, get_config=j_get_config,
                reduced=j_reduced, moe=jmoe, Engine=JEngine,
                Request=JRequest)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs and kernels have no "
                    "CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _cfg(arch, ref=None, **kw):
    """The reduced config of ``arch`` (jamba: one period of 8 layers), and
    the reference's twin when ``ref`` is given."""
    if arch.startswith("jamba"):
        kw.setdefault("n_layers", 8)
    else:
        kw.setdefault("n_layers", 2)
    cfg = reduced(get_config(arch), **kw)
    if ref is None:
        return cfg
    return cfg, ref["reduced"](ref["get_config"](arch), **kw)


# ------------------------------------------------------------ routing

def _moe_cfgs(arch, ref):
    """``arch`` reduced, with its published expert count and top-k and a
    capacity factor of 0.5, so that some pairs are dropped."""
    full = get_config(arch)
    kw = dict(MOE[arch], n_experts=full.n_experts, top_k=full.top_k,
              capacity_factor=0.5)
    return _cfg(arch, ref, **kw)


def _moe_inputs(cfg, seed):
    """x [2, 64, D] and the expert weights, seeded numpy, fp32."""
    rng = np.random.default_rng(seed)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff_expert

    def normal(*shape, scale):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    return dict(x=normal(2, 64, D, scale=1.0),
                router=normal(D, E, scale=D ** -0.5),
                w1=normal(E, D, F, scale=D ** -0.5),
                wg=normal(E, D, F, scale=D ** -0.5),
                w2=normal(E, F, D, scale=F ** -0.5))


def _ref_route(jnp, jax, x, router, cfg):
    """The reference's routing, ``repro/models/moe.py:64-80`` written out:
    fp32 router, top-k, renorm, stable argsort by expert, bincount of
    fixed length E, rank within the expert, kept = rank < C."""
    T, K = x.shape[0], cfg.top_k
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    gates, eidx = jax.lax.top_k(probs, K)
    if cfg.router_renorm:
        gates = gates / (gates.sum(-1, keepdims=True) + 1e-9)
    e_flat = eidx.reshape(-1)
    t_flat = jnp.repeat(jnp.arange(T), K)
    order = jnp.argsort(e_flat)
    e_s, t_s, g_s = e_flat[order], t_flat[order], gates.reshape(-1)[order]
    counts = jnp.bincount(e_flat, length=cfg.n_experts)
    rank = jnp.arange(T * K) - (jnp.cumsum(counts) - counts)[e_s]
    from repro.models.moe import _capacity
    return [np.asarray(a) for a in (e_s, t_s, g_s, rank,
                                    rank < _capacity(T, cfg))]


@pytest.mark.parametrize("arch", list(MOE))
def test_route_matches_reference_routing_with_drops(jax_ref, arch):
    cfg, jcfg = _moe_cfgs(arch, jax_ref)
    inp = _moe_inputs(cfg, seed=3)
    x = inp["x"].reshape(-1, cfg.d_model)
    want = _ref_route(jax_ref["jnp"], jax_ref["jax"], x, inp["router"], jcfg)
    got = [t.numpy() for t in tmoe._route(torch.from_numpy(x),
                                          torch.from_numpy(inp["router"]),
                                          cfg)]
    assert tmoe._capacity(x.shape[0], cfg) == jax_ref["moe"]._capacity(
        x.shape[0], jcfg)
    assert (~want[4]).any() and want[4].any(), "no pair dropped, or all"
    for name, g, w in zip(("expert", "token", "rank", "kept"),
                          (got[0], got[1], got[3], got[4]),
                          (want[0], want[1], want[3], want[4])):
        np.testing.assert_array_equal(g, w, err_msg=name)
    np.testing.assert_allclose(got[2], want[2], atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("arch", list(MOE))
def test_moe_local_matches_reference_with_drops(jax_ref, arch):
    cfg, jcfg = _moe_cfgs(arch, jax_ref)
    inp = _moe_inputs(cfg, seed=4)
    jnp = jax_ref["jnp"]
    want = jax_ref["moe"]._moe_local(
        *(jnp.asarray(inp[k]) for k in ("x", "router", "w1", "wg", "w2")),
        jcfg, ep_axis=None, compute_dtype=jnp.float32)
    got = tmoe._moe_local(
        *(torch.from_numpy(inp[k]) for k in ("x", "router", "w1", "wg", "w2")),
        cfg, compute_dtype=F32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)


# ------------------------------------------------------------ static state

def _drive(engine, admit, prompts, max_new):
    """Admit ``prompts`` as slots free up, step until all are done; returns
    each request's tokens in order. ``admit`` makes a request object."""
    reqs = [admit(i, p, n) for i, (p, n) in enumerate(zip(prompts, max_new))]
    pending = list(reqs)
    while pending or engine.active_slots():
        free = len(engine.free_slots())
        if free and pending:
            engine.admit_many(pending[:free])
            pending = pending[free:]
        engine.step()
    return [r.tokens for r in reqs]


def _static_buffers(engine):
    bufs = {name: getattr(engine, name) for name in
            ("_slot_lengths", "_budget", "_active", "_last", "_out")}
    for sub, leaves in engine.cache.items():
        for leaf, t in leaves.items():
            bufs[f"cache/{sub}/{leaf}"] = t
    return {name: t.data_ptr() for name, t in bufs.items()}


@pytest.mark.parametrize("arch", SERVED)
def test_step_writes_static_buffers_tokens_match_jax(jax_ref, arch):
    """Five requests through three slots (slots are reused): the slot
    state, the step's output and the cache keep their addresses, ``_step``
    returns the output buffer itself, and greedy tokens are identical to
    the JAX engine's at fp32."""
    jax, jnp = jax_ref["jax"], jax_ref["jnp"]
    cfg, jcfg = _cfg(arch, jax_ref)
    params = init_params(cfg, generator=torch.Generator().manual_seed(2),
                         device="cpu", dtype=F32)
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()), params)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 5, 12, 3)]
    max_new = [4, 6, 2, 5, 3]
    eng = GenerationEngine(cfg, params, slots=3, max_len=MAX_LEN,
                           compute_dtype=F32, device="cpu")
    before = _static_buffers(eng)
    got = _drive(eng, lambda i, p, n: Request(i, p, n), prompts, max_new)
    assert _static_buffers(eng) == before
    assert eng._step() is eng._out
    assert eng.host_syncs == eng.admit_calls + eng.steps
    jeng = jax_ref["Engine"](jcfg, jparams, slots=3, max_len=MAX_LEN,
                             compute_dtype=jnp.float32)
    want = _drive(jeng, lambda i, p, n: jax_ref["Request"](i, p, n),
                  prompts, max_new)
    assert got == want
    assert [len(t) for t in got] == max_new


def test_cpu_engine_never_captures():
    cfg = _cfg("qwen2-7b")
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu", dtype=F32)
    for flag in (None, False):
        eng = GenerationEngine(cfg, params, slots=2, max_len=MAX_LEN,
                               compute_dtype=F32, device="cpu",
                               cuda_graph=flag)
        assert eng._graph is None and eng._graph_launches == {}
    with pytest.raises(ValueError, match="needs the card"):
        GenerationEngine(cfg, params, slots=2, max_len=MAX_LEN,
                         compute_dtype=F32, device="cpu", cuda_graph=True)


def test_record_launches_counts_this_thread_only():
    """Launches recorded into a graph are kept apart from the count, and
    only for the recording thread; another thread's launches meanwhile are
    counted as they run. Replays add the record."""
    k = _build.CudaKernel("probe", _build.INCLUDE_DIR / "none.cu", "probe",
                          [])
    k.launches = 0
    with _build.record_launches() as rec:
        k.count_launch()
        other = threading.Thread(target=k.count_launch)
        other.start()
        other.join(timeout=10)
        assert not other.is_alive()
        k.count_launch()
    assert rec == {k: 2} and k.launches == 1
    k.count_launch()
    for _ in range(3):          # three replays
        k.add_launches(rec[k])
    assert k.launches == 8


def test_concurrent_launch_counts_are_not_lost():
    """Drive threads of several engines add to one kernel's count."""
    k = _build.CudaKernel("probe", _build.INCLUDE_DIR / "none.cu", "probe",
                          [])
    k.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [k.count_launch() for _ in range(5000)])
            for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert k.launches == 8 * 5000


# ------------------------------------------------------------ on the card

KERNELS = (fa_kernel.KERNEL, fd_kernel.KERNEL, rs_kernel.KERNEL,
           ms_kernel.KERNEL)


def _layers(cfg):
    return {kind: cfg.n_blocks * cfg.layer_pattern.count(kind)
            for kind in "glmr"}


def _card_model(arch, cuda):
    cfg = _cfg(arch)
    gen = torch.Generator(device=cuda).manual_seed(5)
    params = init_params(cfg, generator=gen,
                         device=cuda, dtype=torch.bfloat16)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n).astype(np.int32)
               for n in (5, 9, 5, 17, 3, 9)]
    return cfg, params, prompts, [6, 3, 8, 4, 5, 7]


@pytest.mark.cuda
def test_route_makes_no_host_sync_on_the_card(cuda):
    """The routing runs under ``set_sync_debug_mode("error")``, which
    raises at an op that syncs with the host; ``torch.bincount``, which
    the counts used before, is such an op on the card."""
    cfg = _cfg("olmoe-1b-7b", n_experts=64, top_k=8, capacity_factor=0.5)
    gen = torch.Generator(device=cuda).manual_seed(6)
    x = torch.randn((128, cfg.d_model), generator=gen, device=cuda)
    router = torch.randn((cfg.d_model, cfg.n_experts), generator=gen,
                         device=cuda)
    want = [t.cpu() for t in tmoe._route(x.cpu(), router.cpu(), cfg)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = tmoe._route(x, router, cfg)
        with pytest.raises(RuntimeError, match="synchronizing"):
            torch.bincount(got[0], minlength=cfg.n_experts)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            torch.testing.assert_close(g.cpu(), w, atol=1e-6, rtol=1e-5)
        else:
            assert torch.equal(g.cpu(), w)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", SERVED)
def test_graphed_step_tokens_and_launches_match_eager(cuda, arch):
    """The same requests through a graphed engine and its eager twin on one
    set of bf16 weights: identical greedy tokens; each kernel's launches
    over the drain are those that ran (decode attention: one per attention
    layer per step, replays included); host syncs = admit calls + steps."""
    cfg, params, prompts, max_new = _card_model(arch, cuda)
    layers = _layers(cfg)
    attn = layers["g"] + layers["l"]
    tokens = {}
    for graphed in (True, False):
        eng = GenerationEngine(cfg, params, slots=3, max_len=MAX_LEN,
                               device=cuda, cuda_graph=graphed)
        assert (eng._graph is not None) == graphed
        if graphed:
            assert eng._graph_launches.get(fd_kernel.KERNEL, 0) == attn
            assert sum(eng._graph_launches.values()) == attn
        for k in KERNELS:
            k.launches = 0
        tokens[graphed] = _drive(eng, lambda i, p, n: Request(i, p, n),
                                 prompts, max_new)
        torch.cuda.synchronize()
        assert fd_kernel.KERNEL.launches == attn * eng.steps
        assert fa_kernel.KERNEL.launches == attn * eng.admit_calls
        assert rs_kernel.KERNEL.launches == layers["r"] * eng.admit_calls
        assert ms_kernel.KERNEL.launches == layers["m"] * eng.admit_calls
        assert eng.host_syncs == eng.admit_calls + eng.steps
    assert tokens[True] == tokens[False]
    assert [len(t) for t in tokens[True]] == max_new


@pytest.mark.cuda
def test_encdec_graphed_engine_matches_eager(cuda):
    """Reduced seamless served as the reference serves it (no frames: its
    decoder cross-attends to a zero cross cache of max_len rows), by a
    graphed engine (step and admission graphs) and its eager twin on one
    set of bf16 weights, each driven twice (the graphed engine's second
    drive replays its admission graphs): identical greedy tokens. The step
    graph records one cross-attention (``flash_attention``, a one-row
    query against the cross cache) and one decode attention per layer;
    over a drive, ``flash_attention`` runs twice a layer per admit call
    (causal self-attention, cross-attention) and once a layer per step."""
    cfg, params, prompts, max_new = _card_model(ENCDEC, cuda)
    attn = _layers(cfg)["g"]
    tokens = {}
    for graphed in (True, False):
        eng = GenerationEngine(cfg, params, slots=3, max_len=MAX_LEN,
                               device=cuda, cuda_graph=graphed)
        assert eng._graph_admit == graphed
        if graphed:
            assert eng._graph_launches == {fd_kernel.KERNEL: attn,
                                           fa_kernel.KERNEL: attn}
        before = _static_buffers(eng)
        runs = []
        for _ in range(2):
            for k in KERNELS:
                k.launches = 0
            calls, steps = eng.admit_calls, eng.steps
            runs.append(_drive(eng, lambda i, p, n: Request(i, p, n),
                               prompts, max_new))
            torch.cuda.synchronize()
            calls, steps = eng.admit_calls - calls, eng.steps - steps
            assert fd_kernel.KERNEL.launches == attn * steps
            assert fa_kernel.KERNEL.launches == attn * (2 * calls + steps)
        assert _static_buffers(eng) == before
        assert runs[0] == runs[1]
        assert (eng.admit_replays > 0) == graphed
        tokens[graphed] = runs[0]
    assert tokens[True] == tokens[False]
    assert [len(t) for t in tokens[True]] == max_new


@pytest.mark.cuda
def test_capture_while_another_engine_steps(cuda):
    """Thread A builds (and so captures) a graphed jamba engine while thread
    B keeps stepping an eager qwen2 engine, whose steps allocate and sync.
    Under the thread-local capture mode neither disturbs the other: A's
    recorded launches hold its own attention layer only, A's tokens equal
    its eager twin's, and B's steps ran during A's construction."""
    cfg_a, params_a, prompts, max_new = _card_model("jamba-v0.1-52b", cuda)
    cfg_b, params_b, prompts_b, _ = _card_model("qwen2-7b", cuda)
    eng_b = GenerationEngine(cfg_b, params_b, slots=3, max_len=MAX_LEN,
                             device=cuda, cuda_graph=False)
    started, stop = threading.Event(), threading.Event()
    b_steps, errors = [], []

    def drive_b():
        try:
            uid = 0
            while not stop.is_set():
                if eng_b.free_slots():
                    uid += 1
                    eng_b.admit_many([Request(uid, prompts_b[uid % 6], 30)])
                eng_b.step()
                b_steps.append(time.monotonic())
                started.set()
        except Exception as e:        # reported by the main thread
            errors.append(e)
            started.set()

    built = {}

    def build_a():
        try:
            built["t0"] = time.monotonic()
            built["engine"] = GenerationEngine(cfg_a, params_a, slots=3,
                                               max_len=MAX_LEN, device=cuda)
            built["t1"] = time.monotonic()
        except Exception as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        tb = threading.Thread(target=drive_b)
        tb.start()
        assert started.wait(timeout=120)
        ta = threading.Thread(target=build_a)
        ta.start()
        ta.join(timeout=300)
        assert not ta.is_alive()
        stop.set()
        tb.join(timeout=120)
        assert not tb.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    eng_a = built["engine"]
    assert any(built["t0"] <= t <= built["t1"] for t in b_steps), \
        "B did not step while A captured"
    attn_a = _layers(cfg_a)["g"] + _layers(cfg_a)["l"]
    assert eng_a._graph_launches == {fd_kernel.KERNEL: attn_a}
    twin = GenerationEngine(cfg_a, params_a, slots=3, max_len=MAX_LEN,
                            device=cuda, cuda_graph=False)
    admit = lambda i, p, n: Request(i, p, n)
    assert _drive(eng_a, admit, prompts, max_new) == _drive(
        twin, admit, prompts, max_new)
