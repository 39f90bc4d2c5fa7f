"""Encoder-decoder (seamless-m4t-large-v2) and the frontend stubs
(``speech_stub`` frames, internvl2-2b's ``vit_stub`` patches) of the
PyTorch port against the JAX package, on the CPU at reduced size: weights
from the JAX ``init_params`` through ``params_from_jax``, inputs from numpy
with a seed, through the encoder, cross-attention, ``forward``, prefill and
decode, ``loss_fn`` and its gradients, the train step, the prefill step,
the serving engine and the launchers.

Tolerances are those of ``tests/test_torch_models.py`` and
``tests/test_torch_train.py``: at fp32 compute (and an fp32 cache) both
frameworks compute the same fp32 arithmetic in other orders, so hidden
states and logits agree to atol = rtol = 1e-4, the loss to 1e-6 / 1e-5 and
every gradient leaf to atol 1e-5, rtol 1e-4. The train step runs at bf16
compute with fp32 masters: loss 2e-3 and gradient norm 5e-3 relative, each
master within 3e-3 a step (both round the same bf16 products in other
orders); three steps left to run apart, each side carrying its own state,
run at fp32 compute, at the limits their docstring reads off. Greedy
tokens of the engines must be identical.

Where the port's preallocated cache cannot do what the reference does, it
raises ``ValueError``: frames of another length than the cache's
``enc_len`` (the reference returns a cross cache as long as the frames),
and a cross-attention against ``enc_len`` 0 (the reference divides by
zero).
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference; absent on the card's machine
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import attention as j_attn
from repro.models import transformer as j_tf
from repro.serving import GenerationEngine as JEngine
from repro.serving import Request as JRequest
from repro.serving import generate as j_generate
from repro.training import make_opt_state as j_make_opt_state
from repro.training import make_prefill_step as j_make_prefill_step
from repro.training import make_train_step as j_make_train_step
from repro.training import optimizer as j_opt
from repro_torch import configs as tconfigs
from repro_torch.models import attention as t_attn
from repro_torch.models import convert
from repro_torch.models import transformer as t_tf
from repro_torch.serving import GenerationEngine, Request, generate
from repro_torch.training import (OptimizerConfig, make_opt_state,
                                  make_prefill_step, make_train_step)
from repro_torch.training import optimizer as t_opt

ENCDEC, VLM = "seamless-m4t-large-v2", "internvl2-2b"
ARCHS = [ENCDEC, VLM]
F32 = torch.float32
OPT = dict(peak_lr=1e-3, min_lr_ratio=0.1, warmup_steps=10, total_steps=100)


def _pair(arch, **kw):
    return (jconfigs.reduced(jconfigs.get_config(arch), **kw),
            tconfigs.reduced(tconfigs.get_config(arch), **kw))


def _params(jcfg, tcfg, seed=0):
    jp = j_tf.init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    return jp, convert.params_from_jax(tree, tcfg, device="cpu",
                                       compute_dtype=F32)


def _frontend(cfg, B, S, rng):
    """The frontend input of ``cfg`` as the data pipeline makes it:
    frames [B, S, fd] x 0.1 (one per token position) or patches [B, P,
    fd]; {} for a model without a frontend."""
    if cfg.frontend == "speech_stub":
        return {"frames": rng.standard_normal(
            (B, S, cfg.frontend_dim)).astype(np.float32) * 0.1}
    if cfg.frontend == "vit_stub":
        return {"patches": rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.frontend_dim)).astype(np.float32)}
    return {}


def _batch(cfg, B=2, S=16, seed=5):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[1, 11:] = 0.0                      # a padded tail
    return {"tokens": tokens, "mask": mask, **_frontend(cfg, B, S, rng)}


def _j(d):
    return {k: jnp.asarray(v) for k, v in d.items()}


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _close(got, want, atol, rtol, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=rtol, err_msg=what)


def _first_block(jp, tp):
    return (jax.tree.map(lambda t: t[0], jp["blocks"])["sub0"],
            t_tf._block(tp["blocks"], 0)["sub0"])


# ------------------------------------------------------------ modules

@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_encode_matches_jax(grad):
    """``_encode`` (frontend_proj, bidirectional blocks, enc_final_norm) at
    fp32; under grad mode each block goes through the checkpoint, with the
    same values."""
    jcfg, tcfg = _pair(ENCDEC)
    jp, tp = _params(jcfg, tcfg)
    frames = _frontend(tcfg, 2, 10, np.random.default_rng(1))["frames"]
    want = j_tf._encode(jp, jnp.asarray(frames), jcfg, None, jnp.float32)
    with torch.set_grad_enabled(grad):
        got = t_tf._encode(tp, torch.from_numpy(frames), tcfg, None, F32)
    assert got.shape == (2, 10, tcfg.d_model)
    _close(got, want, 1e-4, 1e-4)


@pytest.mark.parametrize("path", ["encoder_output", "cached"])
def test_cross_attn_apply_matches_jax(path):
    """Cross-attention of the first decoder block: K/V from the encoder
    output (prefill, training), or the precomputed cross K/V of a cache
    with a one-row query (decode), against ``attn_apply`` of the
    reference."""
    jcfg, tcfg = _pair(ENCDEC)
    jp, tp = _params(jcfg, tcfg)
    jsub, tsub = _first_block(jp, tp)
    rng = np.random.default_rng(2)
    S = 6 if path == "encoder_output" else 1
    x = rng.standard_normal((2, S, tcfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 10, tcfg.d_model)).astype(np.float32)
    kw = dict(compute_dtype=jnp.float32)
    if path == "encoder_output":
        want, _ = j_attn.attn_apply(jsub["cross"], jnp.asarray(x), cfg=jcfg,
                                    kv_x=jnp.asarray(enc), **kw)
        got, cache = t_attn.attn_apply(tsub["cross"], torch.from_numpy(x),
                                       cfg=tcfg, kv_x=torch.from_numpy(enc),
                                       compute_dtype=F32)
        assert cache is None
    else:
        jc = j_attn.init_cross_kv_cache(jsub["cross"], jnp.asarray(enc), jcfg,
                                        jnp.float32)
        tc = t_attn.init_cross_kv_cache(tsub["cross"], torch.from_numpy(enc),
                                        tcfg, F32)
        want, _ = j_attn.attn_apply(jsub["cross"], jnp.asarray(x), cfg=jcfg,
                                    kv_x=jnp.asarray(x), cache=jc, **kw)
        got, cache = t_attn.attn_apply(tsub["cross"], torch.from_numpy(x),
                                       cfg=tcfg, kv_x=torch.from_numpy(x),
                                       cache=tc, compute_dtype=F32)
        assert cache is tc
    assert got.shape == (2, S, tcfg.d_model)
    _close(got, want, 1e-4, 1e-4)


def test_init_cross_kv_cache_matches_jax():
    jcfg, tcfg = _pair(ENCDEC)
    jp, tp = _params(jcfg, tcfg)
    jsub, tsub = _first_block(jp, tp)
    enc = np.random.default_rng(3).standard_normal(
        (2, 10, tcfg.d_model)).astype(np.float32)
    want = j_attn.init_cross_kv_cache(jsub["cross"], jnp.asarray(enc), jcfg,
                                      jnp.float32)
    got = t_attn.init_cross_kv_cache(tsub["cross"], torch.from_numpy(enc),
                                     tcfg, F32)
    for kv in ("k", "v"):
        assert tuple(got[kv].shape) == (2, 10, tcfg.n_kv_heads,
                                        tcfg.head_dim)
        _close(got[kv], want[kv], 1e-5, 1e-5, kv)


@pytest.mark.parametrize("arch,S", [(ENCDEC, 12), (VLM, 12), (VLM, 5)],
                         ids=["frames", "patches", "patches_past_prompt"])
def test_forward_with_frontend_matches_jax(arch, S):
    """``forward`` with frames (encoder plus cross-attention) and with
    patches, including a prompt shorter than ``frontend_tokens`` (8 at
    reduced size), where the reference's concatenation gives a hidden
    state of 8 rows: the port keeps it."""
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    b = _batch(tcfg, S=S, seed=4)
    fe = {k: v for k, v in b.items() if k in ("frames", "patches")}
    want, _ = j_tf.forward(jp, jcfg, tokens=jnp.asarray(b["tokens"]),
                           compute_dtype=jnp.float32, **_j(fe))
    got, cache = t_tf.forward(tp, tcfg, tokens=torch.from_numpy(b["tokens"]),
                              compute_dtype=F32, **_t(fe))
    rows = max(S, tcfg.frontend_tokens) if arch == VLM else S
    assert cache is None and got.shape == (2, rows, tcfg.d_model)
    assert want.shape == got.shape
    _close(got, want, 1e-4, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_with_frontend_then_decode_matches_jax(arch):
    """The sequence of the reference's ``test_arch_decode_matches_forward``
    (``tests/test_models.py:57-77``): prefill of S - 1 tokens with the
    frontend's input into a cache of enc_len S, one decode step of the last
    token. Each of the port's logits against the reference's (fp32 compute
    and cache, 1e-4), the cache leaves too (the cross K/V the prefill
    filled), and the decode step's logits against the port's full forward
    at the reference's own tolerance (atol 1e-3, rtol 1e-2)."""
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    B, S = 2, 32
    b = _batch(tcfg, B=B, S=S, seed=6)
    fe = {k: v for k, v in b.items() if k in ("frames", "patches")}
    toks = b["tokens"]
    f32 = dict(compute_dtype=jnp.float32)
    jc = j_tf.init_cache(jcfg, B, S + 2, enc_len=S, dtype=jnp.float32)
    jl, jc, jlen = j_tf.prefill(jp, jcfg, jnp.asarray(toks[:, :S - 1]), jc,
                                **_j(fe), **f32)
    jd, jc, _ = j_tf.decode_step(jp, jcfg, jnp.asarray(toks[:, S - 1:]), jc,
                                 jlen + 1, **f32)
    tc = t_tf.init_cache(tcfg, B, S + 2, enc_len=S, dtype=F32, device="cpu")
    tl, tc, tlen = t_tf.prefill(tp, tcfg, torch.from_numpy(toks[:, :S - 1]),
                                tc, compute_dtype=F32, **_t(fe))
    td, tc, _ = t_tf.decode_step(tp, tcfg, torch.from_numpy(toks[:, S - 1:]),
                                 tc, tlen + 1, compute_dtype=F32)
    _close(tl, jl, 1e-4, 1e-4, "prefill logits")
    _close(td, jd, 1e-4, 1e-4, "decode logits")
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    for sub in jc:
        assert set(tc[sub]) == set(jc[sub])
        for leaf in jc[sub]:
            assert tuple(tc[sub][leaf].shape) == jc[sub][leaf].shape
            _close(tc[sub][leaf], jc[sub][leaf], 1e-4, 1e-4, f"{sub}/{leaf}")
    h, _ = t_tf.forward(tp, tcfg, tokens=torch.from_numpy(toks),
                        compute_dtype=F32, **_t(fe))
    full = t_tf.logits_head(tp, tcfg, h, F32)
    _close(td[:, 0], full[:, S - 1], 1e-3, 1e-2, "decode vs forward")


# ------------------------------------------------------------ training

@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_and_every_gradient_match_jax(arch):
    """``loss_fn`` (remat on) at fp32 compute with the batch's frames or
    patches: the loss, its aux and the gradient of every parameter leaf
    (the encoder's, the cross-attention's and ``frontend_proj``'s included)
    against ``jax.grad`` of ``repro.models.loss_fn``."""
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    batch = _batch(tcfg)

    def jf(p):
        return j_tf.loss_fn(p, _j(batch), jcfg, remat=True,
                            compute_dtype=jnp.float32)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jp)
    work = t_opt.tree_map(lambda p: p.requires_grad_(True), tp)
    tl, taux = t_tf.loss_fn(work, _t(batch), tcfg, remat=True,
                            compute_dtype=F32)
    tl.backward()
    _close(tl, jl, 1e-6, 1e-5, "loss")
    _close(taux["loss_sum"], jaux["loss_sum"], 1e-5, 1e-5, "loss_sum")
    assert float(taux["weight"]) == float(jaux["weight"]) == 15 + 11
    fj, ft = _flat(jg), _flat(t_opt.tree_map(lambda p: p.grad, work))
    assert set(fj) == set(ft)
    assert any(k.startswith("/frontend_proj") for k in ft)
    for key in fj:
        assert ft[key] is not None, key
        _close(ft[key], fj[key], 1e-5, 1e-4, key)


def _port_state(jp, jo, tcfg):
    """The reference's parameters and AdamW state as the port's tensors."""
    def conv(tree):
        return convert.params_from_jax(
            jax.tree.map(lambda x: np.asarray(x, np.float32), tree), tcfg,
            device="cpu", compute_dtype=F32)
    return conv(jp), {"step": torch.tensor(int(jo["step"]), dtype=torch.int32),
                      "m": conv(jo["m"]), "v": conv(jo["v"])}


@pytest.mark.parametrize("n_steps,microbatches", [(1, 1), (3, 2)])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax_at_bf16(arch, n_steps, microbatches):
    """``make_train_step`` at bf16 compute (fp32 masters; the frames or
    patches split into microbatches with the tokens) against the JAX step:
    loss, grad_norm, lr, step and tokens a step, then every master and
    both AdamW moments, which decay the stacked encoder norms [n_enc, D]
    too, as the reference does (``ndim >= 2``).

    Every step starts from the reference's state of the step before. Let
    run apart, the two drift by bf16 rounding that Adam's first updates
    amplify (each parameter moves by about the learning rate whatever its
    gradient): reduced seamless's third step of 2 microbatches then
    differs by 0.62% in the gradient norm. At the reference's parameters
    before that step the port's bf16 norm is 3.1212 and the reference's
    own 3.1307, against 3.1217 at fp32: the gap is the reference's bf16
    noise, not the port."""
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    jstep = jax.jit(j_make_train_step(jcfg, j_opt.OptimizerConfig(**OPT),
                                      microbatches=microbatches))
    tstep = make_train_step(tcfg, OptimizerConfig(**OPT),
                            microbatches=microbatches)
    jo = j_make_opt_state(jp)
    for i in range(n_steps):
        batch = _batch(tcfg, B=4, S=16, seed=10 + i)
        tp, to = _port_state(jp, jo, tcfg)
        jp, jo, jm = jstep(jp, jo, _j(batch))
        tp, to, tm = tstep(tp, to, batch)
        _close(tm["loss"], jm["loss"], 0, 2e-3, "loss")
        _close(tm["grad_norm"], jm["grad_norm"], 0, 5e-3, "grad_norm")
        _close(tm["lr"], jm["lr"], 0, 1e-6, "lr")
        assert int(tm["step"]) == int(jm["step"]) == i + 1
        assert float(tm["tokens"]) == float(jm["tokens"])
        for tree_t, tree_j in ((tp, jp), (to["m"], jo["m"]),
                               (to["v"], jo["v"])):
            fj, ft = _flat(tree_j), _flat(tree_t)
            assert set(fj) == set(ft)
            for key in fj:
                assert ft[key].dtype == F32
                _close(ft[key], fj[key], 3e-3, 0, key)


def _j_fp32_train_step(jcfg, microbatches):
    """The reference's train step (``repro.training.make_train_step``:
    gradients summed over the microbatches in fp32 and divided by their
    count, then ``adamw_update``) with ``loss_fn`` at fp32 compute on the
    fp32 masters, which its bf16 cast leaves no option for."""
    opt_cfg = j_opt.OptimizerConfig(**OPT)

    def loss_of(p, b):
        return j_tf.loss_fn(p, b, jcfg, remat=True,
                            compute_dtype=jnp.float32)

    def step(params, state, batch):
        mbs = jax.tree.map(lambda t: t.reshape(
            (microbatches, t.shape[0] // microbatches) + t.shape[1:]), batch)
        grads = jax.tree.map(jnp.zeros_like, params)
        loss_sum = weight = jnp.float32(0.0)
        for i in range(microbatches):
            (_, aux), g = jax.value_and_grad(loss_of, has_aux=True)(
                params, jax.tree.map(lambda t: t[i], mbs))
            grads = jax.tree.map(jnp.add, grads, g)
            loss_sum, weight = loss_sum + aux["loss_sum"], weight + aux["weight"]
        grads = jax.tree.map(lambda g: g / microbatches, grads)
        params, state, metrics = j_opt.adamw_update(opt_cfg, params, grads,
                                                    state)
        return params, state, dict(metrics, loss=loss_sum / jnp.maximum(
            weight, 1.0), tokens=weight)

    return jax.jit(step)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_run_apart_match_jax_at_fp32(arch, monkeypatch):
    """Three steps of 2 microbatches, each side carrying its own state:
    the port's ``make_train_step`` updates its parameters, AdamW moments
    and step counter in place from step to step, and is never handed the
    reference's. Both compute at fp32 (the port's bf16 cast of the masters
    and ``loss_fn``'s compute dtype switched to fp32; the reference built
    from its own pieces, ``_j_fp32_train_step``), so the two do not drift
    as they do at bf16: loss 1e-6 / 1e-5, grad_norm and lr 1e-5 relative
    (read: 1.2e-7 at most). After each step every first moment within
    1e-7 (read: 8e-9, of moments up to 4e-3) and every second moment
    within 1e-9 (read: 1.2e-10, of up to 7e-5). Every master within 2e-5:
    one element of reduced seamless reads 6.5e-6 from the first step on,
    where Adam's first update g / (|g| + eps) turns an fp32 difference of a
    gradient near eps into a few percent of the learning rate (1e-4 to 3e-4
    over these steps); a moment or step count not carried moves the
    masters by the order of the learning rate."""
    from repro_torch.training import step as t_step
    monkeypatch.setattr(t_step, "_to_compute", lambda p: p)
    monkeypatch.setattr(t_step, "model_loss_fn", functools.partial(
        t_step.model_loss_fn, compute_dtype=F32))
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    jstep = _j_fp32_train_step(jcfg, 2)
    tstep = make_train_step(tcfg, OptimizerConfig(**OPT), microbatches=2)
    jo, to = j_make_opt_state(jp), make_opt_state(tp)
    leaves = [id(t) for t in (_flat(tp) | _flat(to["m"]) | _flat(to["v"])
                              ).values()]
    for i in range(3):
        batch = _batch(tcfg, B=4, S=16, seed=10 + i)
        jp, jo, jm = jstep(jp, jo, _j(batch))
        tp, to, tm = tstep(tp, to, batch)
        _close(tm["loss"], jm["loss"], 1e-6, 1e-5, "loss")
        _close(tm["grad_norm"], jm["grad_norm"], 0, 1e-5, "grad_norm")
        _close(tm["lr"], jm["lr"], 0, 1e-5, "lr")
        assert int(tm["step"]) == int(to["step"]) == int(jm["step"]) == i + 1
        assert float(tm["tokens"]) == float(jm["tokens"])
        for tree_t, tree_j, atol in ((tp, jp, 2e-5), (to["m"], jo["m"], 1e-7),
                                     (to["v"], jo["v"], 1e-9)):
            fj, ft = _flat(tree_j), _flat(tree_t)
            assert set(fj) == set(ft)
            for key in fj:
                _close(ft[key], fj[key], atol, 1e-5, key)
    assert [id(t) for t in (_flat(tp) | _flat(to["m"]) | _flat(to["v"])
                            ).values()] == leaves     # updated in place


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_passes_the_frontend(arch):
    """``make_prefill_step`` hands frames and patches to ``prefill`` as the
    reference's does (``repro/training/step.py:147-149``): logits and the
    filled cache against the JAX prefill step (fp32 compute and cache)."""
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    b = _batch(tcfg, S=12, seed=7)
    fe = {k: v for k, v in b.items() if k in ("frames", "patches")}
    jc = j_tf.init_cache(jcfg, 2, 16, enc_len=12, dtype=jnp.float32)
    tc = t_tf.init_cache(tcfg, 2, 16, enc_len=12, dtype=F32, device="cpu")
    jl, jc, _ = j_make_prefill_step(jcfg)(
        jax.tree.map(lambda x: x, jp), jnp.asarray(b["tokens"]), jc,
        **_j(fe))
    tl, tc, _ = make_prefill_step(tcfg)(tp, torch.from_numpy(b["tokens"]),
                                        tc, **_t(fe))
    # the reference's step computes in bf16 (its default): the port's too
    _close(tl, jl, 3e-2, 3e-2, "logits")
    for sub in jc:
        for leaf in jc[sub]:
            _close(tc[sub][leaf], jc[sub][leaf], 3e-2, 3e-2, f"{sub}/{leaf}")
    # and at fp32 through the model function, the tight tolerance
    tc32 = t_tf.init_cache(tcfg, 2, 16, enc_len=12, dtype=F32, device="cpu")
    jl32, _, _ = j_tf.prefill(jp, jcfg, jnp.asarray(b["tokens"]),
                              j_tf.init_cache(jcfg, 2, 16, enc_len=12,
                                              dtype=jnp.float32),
                              compute_dtype=jnp.float32, **_j(fe))
    tl32, _, _ = t_tf.prefill(tp, tcfg, torch.from_numpy(b["tokens"]), tc32,
                              compute_dtype=F32, **_t(fe))
    _close(tl32, jl32, 1e-4, 1e-4, "fp32 logits")


# ------------------------------------------------------------ serving

@pytest.mark.parametrize("arch", ARCHS)
def test_generate_tokens_match_jax(arch):
    """``generate`` through the engine, as the reference's engine serves
    these models: no frames or patches (a served internvl2-2b is a text
    model), and seamless's decoder cross-attends to a zero cross cache of
    max_len rows (enc_len = max_len) whose output is exactly 0. Greedy
    tokens at fp32 compute, identical."""
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    prompts = np.random.default_rng(8).integers(0, tcfg.vocab, (3, 6))
    want = j_generate(jcfg, jp, prompts, max_new_tokens=5, max_len=32,
                      compute_dtype=jnp.float32)
    got = generate(tcfg, tp, prompts, max_new_tokens=5, max_len=32,
                   compute_dtype=F32, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_ragged_admission_matches_jax(arch):
    """Three prompts of 3, 9 and 17 tokens (buckets 8, 16 and 32: three
    admit calls, each writing its rows' self and cross K/V into the slot
    cache with ``index_copy_``) and 6 new tokens each, against the JAX
    engine's tokens; the slot cache holds cross K/V of max_len rows."""
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, tcfg.vocab, n).astype(np.int32)
               for n in (3, 9, 17)]
    jeng = JEngine(jcfg, jp, slots=3, max_len=40, compute_dtype=jnp.float32)
    jreqs = [JRequest(i, p, max_new_tokens=6) for i, p in enumerate(prompts)]
    jeng.admit_many(jreqs)
    while jeng.active_slots():
        jeng.step()
    eng = GenerationEngine(tcfg, tp, slots=3, max_len=40, compute_dtype=F32,
                           device="cpu")
    reqs = [Request(i, p, max_new_tokens=6) for i, p in enumerate(prompts)]
    eng.admit_many(reqs)
    while eng.active_slots():
        eng.step()
    assert [r.tokens for r in reqs] == [r.tokens for r in jreqs]
    assert eng.counters()["admit_calls"] == 3
    if tcfg.is_encdec:
        assert eng.cache["sub0"]["cross_k"].shape[2] == 40
        assert not eng.cache["sub0"]["cross_k"].any()


# ------------------------------------------------------------ refusals

def test_frames_must_fill_the_cross_cache():
    """7 frames into a cache built with enc_len 16: the reference returns
    a cross cache of 7 rows (``transformer.py:257-259`` replaces the
    entry); the port's cache is updated in place, so it raises rather than
    pad (zero keys would join every later softmax)."""
    jcfg, tcfg = _pair(ENCDEC)
    jp, tp = _params(jcfg, tcfg)
    toks = np.arange(5, dtype=np.int32)[None]
    frames = _frontend(tcfg, 1, 7, np.random.default_rng(10))["frames"]
    _, jc, _ = j_tf.prefill(jp, jcfg, jnp.asarray(toks),
                            j_tf.init_cache(jcfg, 1, 8, enc_len=16),
                            frames=jnp.asarray(frames))
    assert jc["sub0"]["cross_k"].shape[2] == 7
    tc = t_tf.init_cache(tcfg, 1, 8, enc_len=16, device="cpu")
    with pytest.raises(ValueError, match="enc_len 16"):
        t_tf.prefill(tp, tcfg, torch.from_numpy(toks), tc,
                     frames=torch.from_numpy(frames))


def test_cross_attention_against_enc_len_zero_raises():
    """``init_cache`` at its default enc_len 0, then a prefill without
    frames: the reference divides by zero in its attention
    (``flash_attention/ops.py:94``); the port raises ``ValueError`` at the
    first cross-attention, before any kernel could launch."""
    jcfg, tcfg = _pair(ENCDEC)
    jp, tp = _params(jcfg, tcfg)
    toks = np.arange(5, dtype=np.int32)[None]
    with pytest.raises(ZeroDivisionError):
        j_tf.prefill(jp, jcfg, jnp.asarray(toks), j_tf.init_cache(jcfg, 1, 8))
    tc = t_tf.init_cache(tcfg, 1, 8, device="cpu")
    assert tc["sub0"]["cross_k"].shape[2] == 0
    with pytest.raises(ValueError, match="enc_len 0"):
        t_tf.prefill(tp, tcfg, torch.from_numpy(toks), tc)


def test_only_unknown_layer_kinds_raise():
    for arch in ARCHS:
        t_tf.check_supported(tconfigs.get_config(arch))
    _, tcfg = _pair(ENCDEC, layer_pattern="x")
    with pytest.raises(NotImplementedError, match="'x'"):
        t_tf.check_supported(tcfg)


# ------------------------------------------------------------ launchers

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.serve --arch <arch> --reduced
    --device cpu``: every request served, the reference's report."""
    from repro_torch.launch.serve import main
    assert main(["--arch", arch, "--reduced", "--requests", "5",
                 "--prompt-len", "6", "--max-new", "3", "--slots", "2",
                 "--max-len", "32", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 5 requests, 15 tokens" in out
    assert "t0: 3 reqs" in out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_on_the_cpu(arch, capsys):
    """``python -m repro_torch.launch.train --arch <arch> --reduced``: the
    pipeline's frames or patches reach the step, and the loss is finite."""
    from repro_torch.launch.train import main
    assert main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
                 "--seq", "16", "--log-every", "1", "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert len(lines) == 2
    assert all(np.isfinite(float(ln.split("loss=")[1].split()[0]))
               for ln in lines)
