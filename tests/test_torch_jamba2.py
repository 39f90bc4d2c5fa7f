"""AI21-Jamba2-Mini's published block in the port, on the CPU at a tiny
size: the Mamba mixer's inner norms (``mamba_inner_norms``), the router's
top-2 taken as it is (``router_renorm=False``) and an expert layer that
drops nothing (``capacity_factor = n_experts / top_k``), held to the
benchmark's plain reference ``vcbench/reference/jamba.py`` (HF
``modeling_jamba.py`` written out in float32), and the engine's MoE pair
counters. The JAX package has no such block, so the reference is that
module; jamba-v0.1's parity with the JAX package is
``test_torch_models.py``'s."""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.models import decode_step, init_cache, prefill
from repro_torch.models import moe as tmoe
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba import (init_mamba_block, mamba_apply,
                                      mamba_block_axes)
from repro_torch.serving import GenerationEngine, Request

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "vcbench"))
from harness.weights import make_weights  # noqa: E402
from reference import jamba  # noqa: E402

TINY = {"name": "tiny-jamba2", "family": "hybrid", "n_layers": 8,
        "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "head_dim": 16,
        "d_ff": 96, "vocab": 256, "act": "silu", "norm_eps": 1e-6,
        "use_rope": False, "layer_pattern": "mmmmgmmm", "n_experts": 4,
        "top_k": 2, "d_ff_expert": 32, "moe_every": 2, "moe_offset": 1,
        "capacity_factor": 2.0, "router_renorm": False,
        "mamba_d_state": 8, "mamba_d_conv": 4, "mamba_expand": 2,
        "mamba_dt_rank": 8, "mamba_inner_norms": True}
CFG = ModelConfig(**TINY)
F32 = torch.float32
CPU = torch.device("cpu")
A_MAX = math.log(2.0)


def _weights(seed):
    """The benchmark's weights for the tiny model (its leaves' kinds and
    scales), in float32, with every A_log at most log 2. The program's
    scan clamps dt A at -5 (the JAX package's rule) and the published
    model does not; |A| <= 2 with these weights' dt (at most ~2.3) keeps
    every step inside the clamp, so that what is compared here is the
    block's wiring (``_max_log_decay`` checks it)."""
    w = make_weights({"name": TINY["name"], "model": TINY,
                      "reference": "vcbench/reference/jamba.py"},
                     seed, CPU, F32)
    for i, kind in enumerate(TINY["layer_pattern"]):
        if kind == "m":
            w["blocks"][f"sub{i}"]["mamba"]["A_log"].clamp_(max=A_MAX)
    return w


def _sub(w, i):
    return jamba._layer(w["blocks"][f"sub{i}"], 0)


def _max_log_decay(p, x):
    """The most negative dt A of the mixer ``p`` over x [T, d]: its
    convolution, time step and norm written out."""
    di, dc, dtr = CFG.mamba_d_inner, CFG.mamba_d_conv, CFG.dt_rank
    u = F.pad(x @ p["in_proj"]["w"][:, :di], (0, 0, dc - 1, 0))
    u = F.silu(u.unfold(0, dc, 1).mul(p["conv_w"].T).sum(-1) + p["conv_b"])
    t = jamba.Ref(TINY).norm((u @ p["x_proj"]["w"])[:, :dtr], p["dt_norm"])
    dt = F.softplus(t @ p["dt_proj"]["w"] + p["dt_proj"]["b"])
    return float((dt[:, :, None] * -torch.exp(p["A_log"])).min())


# ---------------------------------------------------------------- experts

def _forced_router(capacity_factor, T=40):
    """Every token routed to experts 2 and 1 (in that order): a router
    that reads only feature 0, which every token has at 4."""
    cfg = ModelConfig(**dict(TINY, capacity_factor=capacity_factor))
    g = torch.Generator().manual_seed(1)
    x = torch.randn((1, T, 64), generator=g)
    x[..., 0] = 4.0
    router = torch.zeros(64, 4)
    router[0, 2], router[0, 1] = 2.0, 1.0
    p = {"router": router,
         "w1": torch.randn((4, 64, 32), generator=g) / 8,
         "wg": torch.randn((4, 64, 32), generator=g) / 8,
         "w2": torch.randn((4, 32, 64), generator=g) / 6}
    sink = torch.zeros(2, dtype=torch.int64)
    with tmoe.count_pairs(sink):
        got = tmoe._moe_local(x, p["router"], p["w1"], p["wg"], p["w2"],
                              cfg, F32)
    return got, tmoe.moe_ref(p, x, cfg), sink.tolist(), cfg


def test_capacity_of_experts_over_k_drops_nothing():
    got, want, (pairs, kept), cfg = _forced_router(2.0)
    assert tmoe._capacity(40, cfg) >= 40
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert pairs == kept == 80            # 40 tokens x top-2, none dropped


def test_capacity_of_1_25_drops_pairs_of_the_same_input():
    got, want, (pairs, kept), cfg = _forced_router(1.25)
    assert tmoe._capacity(40, cfg) == 32
    assert pairs == 80 and kept == 64     # 8 past the capacity, 2 experts
    assert not torch.allclose(got, want, atol=1e-3)


def test_pairs_are_not_counted_outside_count_pairs():
    cfg = ModelConfig(**TINY)
    x = torch.randn(1, 5, 64)
    p = {"router": torch.randn(64, 4), "w1": torch.randn(4, 64, 32),
         "wg": torch.randn(4, 64, 32), "w2": torch.randn(4, 32, 64)}
    sink = torch.zeros(2, dtype=torch.int64)
    with tmoe.count_pairs(sink):
        with tmoe.count_pairs(None):
            tmoe._moe_local(x, p["router"], p["w1"], p["wg"], p["w2"], cfg,
                            F32)
        tmoe._moe_local(x, p["router"], p["w1"], p["wg"], p["w2"], cfg, F32)
    tmoe._moe_local(x, p["router"], p["w1"], p["wg"], p["w2"], cfg, F32)
    assert sink.tolist() == [10, 10]


# ---------------------------------------------------------------- the mixer

def test_inner_norm_leaves_only_with_the_flag():
    off = ModelConfig(**dict(TINY, mamba_inner_norms=False))
    assert not {"dt_norm", "b_norm", "c_norm"} & init_mamba_block(off).keys()
    on = init_mamba_block(CFG)
    assert [on[k].shape for k in ("dt_norm", "b_norm", "c_norm")] == \
        [(8,), (8,), (8,)]
    assert all(on[k].value == 1.0 for k in ("dt_norm", "b_norm", "c_norm"))
    assert mamba_block_axes(CFG)["dt_norm"] == (None,)
    assert "b_norm" not in mamba_block_axes(off)


@pytest.mark.parametrize("impl", ["torch", "ref"])
def test_mixer_matches_the_reference_through_the_scan_and_step_by_step(impl):
    w = _weights(11)
    p = _sub(w, 0)["mamba"]
    g = torch.Generator().manual_seed(2)
    x = torch.randn((1, 45, 64), generator=g)
    assert _max_log_decay(p, x[0]) > -5.0
    want = jamba.Ref(TINY).mixer(x[0], [45], p)
    got, _, _ = mamba_apply(p, x, CFG, impl=impl, compute_dtype=F32)
    torch.testing.assert_close(got[0], want, rtol=2e-5, atol=2e-5)
    # 20 tokens through the scan, then one at a time against the states
    conv = torch.zeros(1, 3, 128)
    ssm = torch.zeros(1, 128, 8)
    head, conv, ssm = mamba_apply(p, x[:, :20], CFG, conv_state=conv,
                                  ssm_state=ssm, impl=impl, compute_dtype=F32)
    outs = [head[0]]
    for t in range(20, 45):
        y, conv, ssm = mamba_apply(p, x[:, t:t + 1], CFG, conv_state=conv,
                                   ssm_state=ssm, impl=impl,
                                   compute_dtype=F32)
        outs.append(y[0])
    torch.testing.assert_close(torch.cat(outs), want, rtol=2e-5, atol=2e-5)
    # without the norms the same weights give another output
    off = ModelConfig(**dict(TINY, mamba_inner_norms=False))
    other, _, _ = mamba_apply(p, x, off, impl=impl, compute_dtype=F32)
    assert (other[0] - want).abs().max() > 0.1


@pytest.mark.parametrize("norms", [True, False])
@pytest.mark.parametrize("impl", ["torch", "ref"])
def test_padded_rows_keep_their_own_states(impl, norms):
    """Rows of 7, 20 and 2 tokens right-padded to 24 with their lengths: at
    each row's valid steps the output, and after the prefill the conv and
    ssm states, are those of the row run alone at its length, so no pad
    step reached a state (also for the row shorter than the conv)."""
    cfg = ModelConfig(**dict(TINY, mamba_inner_norms=norms))
    p = _sub(_weights(15), 0)["mamba"]
    g = torch.Generator().manual_seed(3)
    lens = [7, 20, 2]
    x = torch.randn((3, 24, 64), generator=g)
    got, conv, ssm = mamba_apply(
        p, x, cfg, conv_state=torch.zeros(3, 3, 128),
        ssm_state=torch.zeros(3, 128, 8),
        lengths=torch.tensor(lens, dtype=torch.int32), impl=impl,
        compute_dtype=F32)
    for b, n in enumerate(lens):
        want, c1, s1 = mamba_apply(
            p, x[b:b + 1, :n], cfg, conv_state=torch.zeros(1, 3, 128),
            ssm_state=torch.zeros(1, 128, 8), impl=impl, compute_dtype=F32)
        torch.testing.assert_close(got[b, :n], want[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(conv[b], c1[0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ssm[b], s1[0], rtol=1e-5, atol=1e-5)
    # without the lengths the pad steps run into the states
    _, _, folded = mamba_apply(
        p, x, cfg, conv_state=torch.zeros(3, 3, 128),
        ssm_state=torch.zeros(3, 128, 8), impl=impl, compute_dtype=F32)
    assert (folded[0] - ssm[0]).abs().max() > 1e-3


# ---------------------------------------------------------------- the model

def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, n).astype(np.int32) for n in (9, 9, 17, 30)]


def test_prefill_and_decode_give_the_reference_logits():
    """The models API that the engine calls: a prefill of each prompt,
    then 5 tokens decoded against its cache (float32 K/V here; the
    engine's are bf16), each step's logits against the reference's full
    forward pass over the same tokens."""
    w = _weights(12)
    ref = jamba.Ref(TINY)
    hw = ref.head_w(w)
    for prompt in _prompts():
        cache = init_cache(CFG, 1, 64, dtype=F32, device=CPU)
        logits, cache, lengths = prefill(
            w, CFG, torch.as_tensor(prompt)[None], cache, compute_dtype=F32)
        lengths = lengths + 1           # the first new token's position + 1
        toks, got = [], [logits[0, -1, :256]]
        for _ in range(5):
            toks.append(int(got[-1].argmax()))
            logits, cache, lengths = decode_step(
                w, CFG, torch.tensor([[toks[-1]]], dtype=torch.int32), cache,
                lengths, compute_dtype=F32)
            got.append(logits[0, 0, :256])
        seq = torch.as_tensor(np.concatenate([prompt, toks]))
        h = ref.hidden(w, [seq])[0][len(prompt) - 1:]
        want = torch.cat(list(ref.logits(hw, h)))
        torch.testing.assert_close(torch.stack(got), want, rtol=1e-4,
                                   atol=1e-4)


def test_padded_prefill_gives_each_rows_logits_and_cache():
    """The four prompts right-padded to 32 in one prefill with their
    lengths and ``exact_states``, against each prompt's own prefill: the
    same first-token logits, the same Mamba states and the same attention
    K/V at the prompt's positions; without ``exact_states`` the pad steps
    reach the states, as in the JAX package's prefill."""
    w = _weights(16)
    prompts = _prompts()
    lens = torch.tensor([len(p) for p in prompts], dtype=torch.int32)
    toks = torch.zeros((4, 32), dtype=torch.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = torch.as_tensor(p)
    cache = init_cache(CFG, 4, 64, dtype=F32, device=CPU)
    logits, cache, _ = prefill(w, CFG, toks, cache, lengths=lens,
                               compute_dtype=F32, exact_states=True)
    for b, p in enumerate(prompts):
        one = init_cache(CFG, 1, 64, dtype=F32, device=CPU)
        want, one, _ = prefill(w, CFG, torch.as_tensor(p)[None], one,
                               compute_dtype=F32)
        torch.testing.assert_close(logits[b, 0], want[0, 0], rtol=1e-4,
                                   atol=1e-4)
        for name, sub in one.items():
            for leaf, c in sub.items():
                got = cache[name][leaf][:, b]
                if leaf in ("k", "v"):
                    got, c = got[:, :len(p)], c[:, 0, :len(p)]
                else:
                    c = c[:, 0]
                torch.testing.assert_close(got, c, rtol=1e-4, atol=1e-4,
                                           msg=f"{name}/{leaf}")
    folded = init_cache(CFG, 4, 64, dtype=F32, device=CPU)
    prefill(w, CFG, toks, folded, lengths=lens, compute_dtype=F32)
    assert (folded["sub0"]["ssm"] - cache["sub0"]["ssm"]).abs().max() > 1e-3


def test_engine_serves_the_reference_tokens_and_counts_pairs():
    """Four prompts admitted through ``GenerationEngine`` (right-padded
    bucket groups: 9 and 9 in 16, 17 and 30 in 32) and decoded together:
    every served token is the reference's best at its position, by a
    margin of the reference's own logits, so no pad step reached a Mamba
    state; every routed pair, pad rows' included, was kept."""
    w = _weights(13)
    eng = GenerationEngine(CFG, w, slots=4, max_len=64, compute_dtype=F32,
                           device=CPU)
    reqs = [Request(i + 1, p, 6) for i, p in enumerate(_prompts())]
    eng.admit_many(reqs)
    steps = 0
    while eng.active_slots():
        eng.step()
        steps += 1
    ref = jamba.Ref(TINY)
    hw = ref.head_w(w)
    seqs = [torch.as_tensor(np.concatenate([r.prompt, r.tokens[:-1]]))
            for r in reqs]
    for r, h in zip(reqs, ref.hidden(w, seqs)):
        lg = torch.cat(list(ref.logits(hw, h[len(r.prompt) - 1:])))
        toks = torch.as_tensor(r.tokens)
        assert len(r.tokens) == 6
        gap = lg.amax(-1) - lg.gather(-1, toks[:, None])[:, 0]
        assert float(gap.max()) < 1e-4, (r.uid, gap)
    c = eng.counters()
    # rows x bucket and the steps' slots; top-2; 4 expert layers
    routed = (2 * 16 + 2 * 32 + 4 * steps) * 2 * 4
    assert (c["moe_pairs"], c["moe_pairs_dropped"]) == (routed, 0)
    assert c["admit_calls"] == 2


# ---------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the engine's CUDA graphs and the "
                    "scan kernel have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_engine_matches_eager_and_counts_on_the_device(cuda):
    """The tiny model's bf16 weights through a graphed engine (the step a
    CUDA graph holding the pair counters' adds) and its eager twin: the
    same tokens and the same pair counts over the drain (the graphed
    engine's constructor ran one warm-up step, counted before it); the
    eager step and admission make no host sync
    (``set_sync_debug_mode("error")``)."""
    w = make_weights({"name": TINY["name"], "model": TINY,
                      "reference": "vcbench/reference/jamba.py"},
                     14, cuda, torch.bfloat16)
    out = {}
    for graphed in (True, False):
        eng = GenerationEngine(CFG, w, slots=4, max_len=64, device=cuda,
                               cuda_graph=graphed)
        reqs = [Request(i + 1, p, 6) for i, p in enumerate(_prompts())]
        if not graphed:
            # one row of 9 tokens into slot 0, a budget of 2
            buf = torch.tensor(list(range(1, 10)) + [0, 9, 2],
                               dtype=torch.int32, device=cuda)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                eng._admit_staged(buf, 1, 9)
                eng._step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
            eng._active.zero_()
        before = eng.counters()
        eng.admit_many(reqs)
        while eng.active_slots():
            eng.step()
        after = eng.counters()
        out[graphed] = ([r.tokens for r in reqs],
                        {k: after[k] - before[k] for k in
                         ("moe_pairs", "moe_pairs_dropped", "steps",
                          "admit_calls")})
    assert out[True][0] == out[False][0]
    assert out[True][1] == out[False][1]
    routed = (2 * 16 + 2 * 32 + 4 * out[True][1]["steps"]) * 2 * 4
    assert out[True][1]["moe_pairs"] == routed
    assert out[True][1]["moe_pairs_dropped"] == 0
