"""Training path of the PyTorch port against the JAX package, on the CPU.

The same numpy-seeded inputs go through the reference and the port: the
optimizer (fp32 arithmetic on both sides, so 1e-6 relative), the chunked
cross-entropy and its gradients (fp32, 1e-5), attention's training form
(``MhaFunction`` against ``jax.vjp`` of ``_mha_xla``, the reference's
custom VJP: fp32 2e-5 and bf16 2e-2, the tolerances of
``tests/test_kernels.py:50``), ``loss_fn`` and every gradient leaf at fp32
compute on five reduced configs (rwkv6-7b and jamba through the scans'
Functions), and the train step at bf16 compute. The JAX side runs as its
own tests run it on the CPU ("xla"; for jamba's gradients "ref", see
``LOSS_ORACLE_IMPL``).

On the card (marker ``cuda``; skipped without one): the kernel's lse in
both routes against ``_mha_torch``, ``MhaFunction``'s gradients through the
kernel against those through the plain forward, and every ctypes wrapper
refusing to run under autograd.
"""
import types

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference; absent on the card's machine
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.kernels.flash_attention import ops as j_ops
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.models.layers import chunked_softmax_xent as j_xent
from repro.training import optimizer as j_opt
from repro.training import make_opt_state as j_make_opt_state
from repro.training import make_train_step as j_make_train_step
from repro_torch import configs as tconfigs
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.models import convert
from repro_torch.models import init_params as t_init_params
from repro_torch.models import loss_fn as t_loss_fn
from repro_torch.models.layers import chunked_softmax_xent as t_xent
from repro_torch.training import optimizer as t_opt
from repro_torch.training import (OptimizerConfig, make_opt_state,
                                  make_train_step)

OPT = dict(peak_lr=1e-3, min_lr_ratio=0.1, warmup_steps=10, total_steps=100)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _np(x):
    return np.asarray(x.detach().float() if torch.is_tensor(x) else x,
                      np.float32)


def _close(got, want, atol, rtol, what=""):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=what)


# ------------------------------------------------------------ optimizer

@pytest.mark.parametrize("step", [0, 5, 10, 55, 100])
def test_lr_schedule_matches_jax(step):
    """Steps 0, warmup/2, warmup, mid and end, fp32 on both sides."""
    j = j_opt.lr_schedule(j_opt.OptimizerConfig(**OPT), jnp.int32(step))
    t = t_opt.lr_schedule(t_opt.OptimizerConfig(**OPT),
                          torch.tensor(step, dtype=torch.int32))
    assert t.dtype == torch.float32
    _close(t, j, 0, 1e-6)


def _opt_trees(seed):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "stack": {"ln": (3, 5), "b": (4,)},
              "e": (2, 3, 4)}

    def make(scale):
        return {"w": rng.standard_normal(shapes["w"]).astype(np.float32) * scale,
                "stack": {k: rng.standard_normal(s).astype(np.float32) * scale
                          for k, s in shapes["stack"].items()},
                "e": rng.standard_normal(shapes["e"]).astype(np.float32) * scale}
    return make(1.0), [make(0.3) for _ in range(3)]


@pytest.mark.parametrize("clip_norm", [1.0, 1e9])
def test_adamw_update_matches_jax(clip_norm):
    """Three AdamW steps on the same numpy trees (a matrix, stacked norm
    scales [n, D] that the reference decays as ``ndim >= 2``, a bias and a
    3-D leaf), with and without the clip binding: fp32, 1e-6 relative."""
    p0, grads = _opt_trees(0)
    jcfg = j_opt.OptimizerConfig(**OPT, clip_norm=clip_norm)
    tcfg = t_opt.OptimizerConfig(**OPT, clip_norm=clip_norm)
    jp = jax.tree.map(jnp.asarray, p0)
    tp = t_opt.tree_map(torch.from_numpy, _copy(p0))
    js, ts = j_opt.init_opt_state(jp), t_opt.init_opt_state(tp)
    for g in grads:
        jp, js, jm = j_opt.adamw_update(jcfg, jp, jax.tree.map(jnp.asarray, g),
                                        js)
        tg = t_opt.tree_map(torch.from_numpy, _copy(g))
        tp, ts, tm = t_opt.adamw_update(tcfg, tp, tg, ts)
        for k in ("lr", "grad_norm", "step"):
            _close(tm[k], jm[k], 0, 1e-6, k)
        # the gradients are not modified
        for a, b in zip(t_opt.tree_leaves(tg), t_opt.tree_leaves(
                t_opt.tree_map(torch.from_numpy, g))):
            assert torch.equal(a, b)
    assert int(ts["step"]) == int(js["step"]) == 3
    assert ts["step"].dtype == torch.int32
    for tree_t, tree_j in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
        ft, fj = _flat(tree_t), _flat(tree_j)
        assert set(ft) == set(fj)
        for k in ft:
            _close(ft[k], fj[k], 1e-7, 1e-6, k)


def _copy(tree):
    return {k: _copy(v) if isinstance(v, dict) else v.copy()
            for k, v in tree.items()}


def test_clip_by_global_norm_matches_jax():
    _, grads = _opt_trees(1)
    g = grads[0]
    jc, jn = j_opt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.5)
    tc, tn = t_opt.clip_by_global_norm(t_opt.tree_map(torch.from_numpy, g),
                                       0.5)
    _close(tn, jn, 0, 1e-6)
    ft, fj = _flat(tc), _flat(jc)
    for k in ft:
        _close(ft[k], fj[k], 1e-7, 1e-6, k)


def test_grad_clip_bounds_update():
    """Twin of ``tests/test_training_data_ckpt.py::test_grad_clip_bounds_update``."""
    cfg = OptimizerConfig(peak_lr=1.0, warmup_steps=0, clip_norm=1.0,
                          weight_decay=0.0)
    params = {"w": torch.zeros(4)}
    state = t_opt.init_opt_state(params)
    _, _, metrics = t_opt.adamw_update(cfg, params,
                                       {"w": torch.full((4,), 100.0)}, state)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)


# ------------------------------------------------------------ chunked loss

@pytest.mark.parametrize("softcap,valid", [(0.0, 0), (30.0, 50), (0.0, 50)])
def test_chunked_softmax_xent_matches_jax(softcap, valid):
    """S 37 with chunks of 16 (a ragged last chunk), V 64 with the rows
    past ``valid`` masked, a mask with zeros: value and the gradients of h
    and the vocab matrix against ``jax.grad``, fp32 compute, 1e-5."""
    rng = np.random.default_rng(2)
    B, S, D, V = 2, 37, 24, 64
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    w = rng.standard_normal((D, V)).astype(np.float32) * 0.5
    labels = rng.integers(0, valid or V, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    kw = dict(chunk=16, final_softcap=softcap, valid_vocab=valid)

    @jax.jit
    def jf(h, w):
        (ls, ws), vjp = jax.vjp(lambda h, w: j_xent(
            h, w, jnp.asarray(labels), mask=jnp.asarray(mask),
            compute_dtype=jnp.float32, **kw), h, w)
        return ls, ws, vjp((jnp.float32(1.0), jnp.float32(0.0)))

    jl, jw, (jdh, jdw) = jf(jnp.asarray(h), jnp.asarray(w))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    tl, tws = t_xent(th, tw, torch.from_numpy(labels),
                     mask=torch.from_numpy(mask), compute_dtype=torch.float32,
                     **kw)
    tl.backward()
    _close(tl, jl, 1e-5, 1e-5)
    assert float(tws) == float(jw)
    _close(th.grad, jdh, 1e-5, 1e-5)
    _close(tw.grad, jdw, 1e-5, 1e-5)


# ------------------------------------------------------------ attention VJP

VJP_CASES = [
    # B, S, T, H, KV, D, causal, window, softcap, q_offset, q_chunk, kv_chunk
    (2, 100, 100, 4, 2, 32, True, 0, 0.0, 0, 32, 48),     # ragged chunks, GQA
    (1, 90, 90, 4, 1, 16, True, 24, 0.0, 0, 32, 32),      # window masks tiles
    (1, 64, 64, 2, 2, 32, True, 0, 50.0, 0, 24, 40),      # softcap
    (2, 40, 100, 4, 2, 16, True, 16, 30.0, 60, 16, 32),   # q_offset + window
    (1, 48, 48, 2, 1, 32, False, 0, 0.0, 0, 32, 32),      # bidirectional
    (2, 24, 60, 4, 4, 64, False, 0, 0.0, 0, 16, 32),      # cross, S < T
]
VJP_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _vjp_inputs(case, seed=3):
    B, S, T, H, KV, D = case[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, D), (B, T, KV, D), (B, T, KV, D),
                      (B, S, H, D))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", VJP_CASES)
def test_mha_function_matches_jax_vjp(case, dtype):
    """out, lse and dq/dk/dv of ``mha`` under autograd ("torch": the
    plain forward and ``_mha_bwd_torch``) against ``jax.vjp`` of
    ``_mha_xla`` and its ``_mha_fwd_impl``."""
    B, S, T, H, KV, D, causal, window, softcap, qoff, cq, ckv = case
    q, k, v, do = _vjp_inputs(case)
    kw = dict(causal=causal, window=window, softcap=softcap, scale=None,
              q_offset=qoff, q_chunk=cq, kv_chunk=ckv)
    jd = getattr(jnp, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jd) for x in (q, k, v, do))

    @jax.jit
    def jf(a, b, c, d):
        out, vjp = jax.vjp(lambda a, b, c: j_ops._mha_xla(a, b, c, **kw),
                           a, b, c)
        return out, j_ops._mha_fwd_impl(a, b, c, **kw)[1], vjp(d)

    jout, jlse, (jdq, jdk, jdv) = jf(jq, jk, jv, jdo)

    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(td).requires_grad_(True)
                  for x in (q, k, v))
    out = t_ops.mha(tq, tk, tv, impl="torch", **kw)
    assert out.grad_fn is not None and "MhaFunction" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(do).to(td))
    _, tlse = t_ops._mha_torch(tq.detach(), tk.detach(), tv.detach(), **kw)
    tol = VJP_TOL[dtype]
    assert tlse.dtype == torch.float32 and tlse.shape == (B, S, KV, H // KV)
    _close(tlse, jlse, 2e-5 if dtype == "float32" else 1e-4, 1e-5, "lse")
    _close(out, jout, tol, tol, "out")
    for name, got, want in (("dq", tq.grad, jdq), ("dk", tk.grad, jdk),
                            ("dv", tv.grad, jdv)):
        assert got.dtype == td
        _close(got, want, tol, tol, name)


def test_mha_ref_trains_by_plain_autograd():
    """"ref" keeps plain autograd and agrees with the Function's gradients
    (fp32, 2e-5)."""
    case = VJP_CASES[0]
    q, k, v, do = _vjp_inputs(case, seed=4)
    grads = {}
    for impl in ("ref", "torch"):
        ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
        out = t_ops.mha(*ts, impl=impl, q_chunk=32, kv_chunk=48)
        assert ("MhaFunction" in type(out.grad_fn).__name__) == (impl == "torch")
        out.backward(torch.from_numpy(do))
        grads[impl] = [t.grad for t in ts]
    for a, b in zip(grads["ref"], grads["torch"]):
        _close(a, b, 2e-5, 2e-5)


def test_mha_without_grad_takes_no_function():
    q, k, v, _ = _vjp_inputs(VJP_CASES[0])
    ts = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    with torch.no_grad():
        out = t_ops.mha(*ts, impl="torch")
    assert out.grad_fn is None
    out2 = t_ops.mha(*[t.detach() for t in ts], impl="torch")
    assert out2.grad_fn is None and torch.equal(out, out2)


# ------------------------------------------------------------ loss_fn

LOSS_ARCHS = {
    # gemma2's window cut to 6 so that it binds at S 16
    "qwen2-7b": {},
    "gemma2-9b": {"sliding_window": 6},
    "olmoe-1b-7b": {},
    "rwkv6-7b": {},
    "jamba-v0.1-52b": {},
}
# The oracle for jamba is the reference's loss_fn with impl="ref" (the
# Mamba scan's exact per-step recurrence). Its default path ("xla": the
# chunked scan, as the port's) gives gradients that differ from its own
# "ref" by up to 3.0e-2 of A_log's largest magnitude and 1e-4 to 3.7e-3 of
# every other leaf's (the loss agrees); with only the Mamba scan switched
# to "ref" the whole tree agrees with "ref" to 1.4e-6, so the gap is the
# reference's chunked scan at jamba's inputs. The port's chunked scan, its
# plain autograd and the Function alike, agrees with "ref" to 2e-5
# (ROADMAP.md §3, reference facts).
LOSS_ORACLE_IMPL = {"jamba-v0.1-52b": "ref"}


def _pair(arch, **kw):
    kw = {**LOSS_ARCHS.get(arch, {}), **kw}
    j = jconfigs.reduced(jconfigs.get_config(arch), **kw)
    t = tconfigs.reduced(tconfigs.get_config(arch), **kw)
    return j, t


def _batch(cfg, B=2, S=16, seed=5):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[1, 11:] = 0.0                      # a padded tail
    return {"tokens": tokens, "mask": mask}


def _params(jcfg, tcfg, seed=0):
    jp = j_init_params(jax.random.PRNGKey(seed), jcfg)
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    tp = convert.params_from_jax(tree, tcfg, device="cpu",
                                 compute_dtype=torch.float32)
    return jp, tp


@pytest.mark.parametrize("arch", list(LOSS_ARCHS))
def test_loss_fn_and_every_gradient_match_jax(arch):
    """``loss_fn`` (remat on) at fp32 compute: the loss, its aux and the
    gradient of every parameter leaf against ``jax.grad`` of
    ``repro.models.loss_fn`` (with ``LOSS_ORACLE_IMPL``'s impl where one is
    named). Both sides compute the same fp32 arithmetic in other orders:
    atol 1e-5 on gradients of scale ~1e-2, rtol 1e-4. The recurrent layers
    train through the scans' Functions ("torch")."""
    jcfg, tcfg = _pair(arch)
    jp, tp = _params(jcfg, tcfg)
    batch = _batch(tcfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def jf(p):
        return j_loss_fn(p, jb, jcfg, remat=True, compute_dtype=jnp.float32,
                         impl=LOSS_ORACLE_IMPL.get(arch))

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jp)
    work = t_opt.tree_map(lambda p: p.requires_grad_(True), tp)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tl, taux = t_loss_fn(work, tb, tcfg, remat=True,
                         compute_dtype=torch.float32)
    tl.backward()
    _close(tl, jl, 1e-6, 1e-5, "loss")
    _close(taux["loss_sum"], jaux["loss_sum"], 1e-5, 1e-5, "loss_sum")
    assert float(taux["weight"]) == float(jaux["weight"]) == 15 + 11
    fj, ft = _flat(jg), _flat(t_opt.tree_map(lambda p: p.grad, work))
    assert set(fj) == set(ft)
    for key in fj:
        assert ft[key] is not None, key
        _close(ft[key], fj[key], 1e-5, 1e-4, key)


def test_forward_remat_gives_the_same_gradients():
    """Remat recomputes each block in the backward pass: the loss and the
    gradients are the same as without it, bit for bit."""
    _, tcfg = _pair("qwen2-7b")
    tp = t_init_params(tcfg, generator=torch.Generator().manual_seed(1),
                       device="cpu", dtype=torch.float32)
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    out = {}
    for remat in (False, True):
        work = t_opt.tree_map(lambda p: p.detach().clone().requires_grad_(True),
                              tp)
        loss, _ = t_loss_fn(work, tb, tcfg, remat=remat,
                            compute_dtype=torch.float32)
        loss.backward()
        out[remat] = (loss, [p.grad for p in t_opt.tree_leaves(work)])
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


# ------------------------------------------------------------ train step

def _steps(arch, n_steps, microbatches, B=4, S=16, **cfg):
    jcfg, tcfg = _pair(arch, **cfg)
    jp, tp = _params(jcfg, tcfg)
    jstep = jax.jit(j_make_train_step(jcfg, j_opt.OptimizerConfig(**OPT),
                                      microbatches=microbatches))
    tstep = make_train_step(tcfg, OptimizerConfig(**OPT),
                            microbatches=microbatches)
    jo, to = j_make_opt_state(jp), make_opt_state(tp)
    out = []
    for i in range(n_steps):
        batch = _batch(tcfg, B=B, S=S, seed=10 + i)
        jp, jo, jm = jstep(jp, jo, {k: jnp.asarray(v) for k, v in batch.items()})
        tp, to, tm = tstep(tp, to, batch)
        out.append((jm, tm))
    return out, (jp, tp)


@pytest.mark.parametrize("n_steps,microbatches", [(1, 1), (3, 2)])
def test_train_step_matches_jax_at_bf16(n_steps, microbatches):
    """``make_train_step`` on reduced qwen2-7b at bf16 compute (fp32
    masters) against the JAX step: loss, grad_norm, lr, step and tokens.
    Both round the same bf16 products, but in other orders and with one
    rounding of the other framework's choosing at places: the loss of ~5.8
    agrees to 2e-3 relative and the gradient norm of ~1.9 to 5e-3 (seen:
    3e-4 and 2.4e-4)."""
    out, (jp, tp) = _steps("qwen2-7b", n_steps, microbatches)
    for jm, tm in out:
        _close(tm["loss"], jm["loss"], 0, 2e-3, "loss")
        _close(tm["grad_norm"], jm["grad_norm"], 0, 5e-3, "grad_norm")
        _close(tm["lr"], jm["lr"], 0, 1e-6, "lr")
        assert int(tm["step"]) == int(jm["step"])
        assert float(tm["tokens"]) == float(jm["tokens"])
    # the masters moved alike: every leaf within a few learning-rate steps
    fj, ft = _flat(jp), _flat(tp)
    for key in fj:
        assert ft[key].dtype == torch.float32
        _close(ft[key], fj[key], 3e-3 * n_steps, 0, key)


RECURRENT = ["rwkv6-7b", "jamba-v0.1-52b"]


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_remat_gives_the_same_gradients(arch):
    """Remat runs each scan Function's forward twice (in the forward and in
    the recompute before the backward): the loss and the gradients are the
    same as without remat, bit for bit."""
    _, tcfg = _pair(arch)
    tp = t_init_params(tcfg, generator=torch.Generator().manual_seed(1),
                       device="cpu", dtype=torch.float32)
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
    out = {}
    for remat in (False, True):
        work = t_opt.tree_map(lambda p: p.detach().clone().requires_grad_(True),
                              tp)
        loss, _ = t_loss_fn(work, tb, tcfg, remat=remat,
                            compute_dtype=torch.float32)
        loss.backward()
        out[remat] = (loss, [p.grad for p in t_opt.tree_leaves(work)])
    assert torch.equal(out[False][0], out[True][0])
    for a, b in zip(out[False][1], out[True][1]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", RECURRENT)
def test_recurrent_train_step_matches_jax_at_bf16(arch):
    """``make_train_step`` at bf16 compute (fp32 masters; the scans get
    bf16 r/k/v and u, or A and D, and cast them) against the JAX step, one
    step of 2 microbatches, to the tolerances of
    ``test_train_step_matches_jax_at_bf16``: loss 2e-3 and gradient norm
    5e-3 relative, lr 1e-6, every master within 3e-3. jamba runs one
    period of its pattern (8 layers), as the engine tests cut it.

    Why one step, and 8 layers: at bf16 both frameworks are far from the
    fp32 gradient here (reduced rwkv6: the norm 0.64% off it in the port,
    0.92% in the reference; single leaves 10% of their scale), and the two
    round differently at rare elements (one Mamba layer's outputs agree
    but for a few bf16 ulps, 7.5e-4 of the largest). Adam's first updates,
    which move every parameter by about the learning rate whatever its
    gradient, then amplify that: rwkv6's third step differs by 6.1e-3 in
    the norm, and jamba's 16 layers by 2.3e-3 in the first step's loss.
    Each framework's bf16 noise, not the port, sets those."""
    out, (jp, tp) = _steps(arch, 1, 2, **(
        {"n_layers": 8} if arch.startswith("jamba") else {}))
    for jm, tm in out:
        _close(tm["loss"], jm["loss"], 0, 2e-3, "loss")
        _close(tm["grad_norm"], jm["grad_norm"], 0, 5e-3, "grad_norm")
        _close(tm["lr"], jm["lr"], 0, 1e-6, "lr")
        assert int(tm["step"]) == int(jm["step"])
        assert float(tm["tokens"]) == float(jm["tokens"])
    fj, ft = _flat(jp), _flat(tp)
    for key in fj:
        assert ft[key].dtype == torch.float32
        _close(ft[key], fj[key], 3e-3, 0, key)


def test_train_loss_decreases_tiny_rwkv6():
    """A 2-layer rwkv6 of vocab 64 learns one repeated batch: its loss
    falls by more than 0.5 in 15 steps."""
    cfg = tconfigs.reduced(tconfigs.get_config("rwkv6-7b"), n_layers=2,
                           vocab=64)
    params = t_init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    step = make_train_step(cfg, OptimizerConfig(peak_lr=5e-3, warmup_steps=2,
                                                total_steps=50))
    opt = make_opt_state(params)
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 24)).astype(np.int32)}
    losses = []
    for _ in range(15):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_train_loss_decreases_tiny_model():
    """Twin of ``tests/test_training_data_ckpt.py::test_train_loss_decreases_tiny_model``."""
    cfg = tconfigs.reduced(tconfigs.get_config("qwen2-7b"), n_layers=2,
                           vocab=64)
    params = t_init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    step = make_train_step(cfg, OptimizerConfig(peak_lr=5e-3, warmup_steps=2,
                                                total_steps=50))
    opt = make_opt_state(params)
    batch = {"tokens": np.random.default_rng(0).integers(
        0, cfg.vocab, (4, 24)).astype(np.int32)}
    losses = []
    for _ in range(15):
        params, opt, metrics = step(params, opt, batch)
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, losses


def test_mesh_and_grad_compression_raise():
    """A mesh step outside the sharding rules of a plan on that mesh
    raises; ``grad_compress_pod`` without a "pod" mesh axis is ignored as
    in the reference (the same step as without it); and
    ``make_opt_state(grad_compress_pod=True)`` adds the fp32 residual
    "ef". The sharded and compressed steps themselves are held to the
    reference in tests/test_torch_sharded_train.py and
    tests/test_torch_sharding.py."""
    cfg = tconfigs.reduced(tconfigs.get_config("qwen2-7b"), n_layers=2)
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    step = make_train_step(cfg, OptimizerConfig(), mesh=mesh)
    with pytest.raises(ValueError, match="sharding rules"):
        step({}, {}, {})
    params = t_init_params(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu", dtype=torch.float32)
    twin = t_opt.tree_map(torch.clone, params)
    batch = {"tokens": np.arange(16, dtype=np.int32).reshape(2, 8)}
    _, _, m1 = make_train_step(cfg, OptimizerConfig(), grad_compress_pod=True)(
        params, make_opt_state(params), batch)
    _, _, m2 = make_train_step(cfg, OptimizerConfig())(
        twin, make_opt_state(twin), batch)
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(t_opt.tree_leaves(params), t_opt.tree_leaves(twin)):
        assert torch.equal(a, b)
    state = make_opt_state({"w": torch.ones(2, dtype=torch.bfloat16)},
                           grad_compress_pod=True)
    assert set(state) == {"step", "m", "v", "ef"}
    assert state["ef"]["w"].dtype == torch.float32
    assert not state["ef"]["w"].any()


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


LSE_CASES = [
    # B, S, T, H, KV, D, window, softcap (causal, q_offset = T - S)
    (1, 1, 1, 4, 2, 64, 0, 0.0),
    (2, 65, 65, 4, 2, 64, 0, 0.0),
    (1, 1023, 1023, 8, 2, 128, 0, 0.0),
    (2, 100, 300, 4, 4, 64, 0, 0.0),          # T != S
    (1, 300, 300, 4, 2, 64, 100, 0.0),        # window ends inside a kv tile
    (1, 200, 200, 4, 2, 256, 37, 50.0),       # D 256, window, softcap
    (1, 0, 16, 2, 1, 64, 0, 0.0),             # no query rows
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", LSE_CASES)
def test_kernel_lse_matches_plain(cuda, case, dtype):
    """The kernel's out and lse (both routes: fp32 CUDA cores, bf16 wgmma)
    against ``_mha_torch``. lse: fp32 statistics on both sides, apart only
    by summation order and the SFU's exp2/tanh (~1e-6 relative on values
    of ~10): 1e-4."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    B, S, T, H, KV, D, window, softcap = case
    g = torch.Generator(device=cuda).manual_seed(0)
    td = getattr(torch, dtype)
    q = torch.randn((B, S, H, D), generator=g, device=cuda).to(td)
    k, v = (torch.randn((B, T, KV, D), generator=g, device=cuda).to(td)
            for _ in range(2))
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=T - S)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    assert flash_attention(q, k, v, **kw).shape == out.shape   # no lse: a tensor
    ref, ref_lse = t_ops._mha_torch(q, k, v, scale=None, q_chunk=256,
                                    kv_chunk=256, **kw)
    torch.cuda.synchronize()
    assert lse.shape == (B, S, H) and lse.dtype == torch.float32
    _close(lse.view(B, S, KV, H // KV).cpu(), ref_lse.cpu(), 1e-4, 1e-5)
    _close(out.cpu(), ref.cpu(), VJP_TOL[dtype], VJP_TOL[dtype])


@pytest.mark.cuda
def test_kernel_lse_of_an_empty_key_range(cuda):
    """T 0 on the bf16 route: out 0 and lse -1e30, the reference's value
    for a row that sees no key."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    q = torch.randn((1, 8, 4, 64), device=cuda).bfloat16()
    k = torch.zeros((1, 0, 2, 64), device=cuda).bfloat16()
    out, lse = flash_attention(q, k, k, causal=False, return_lse=True)
    torch.cuda.synchronize()
    assert torch.all(out == 0) and torch.all(lse == -1e30)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", VJP_CASES)
def test_mha_function_grads_through_the_kernel(cuda, case, dtype):
    """dq/dk/dv with the kernel's forward ("cuda") against the same
    backward on the plain forward ("torch"): only the forward's out and
    lse differ, by the forward's tolerance."""
    B, S, T, H, KV, D, causal, window, softcap, qoff, cq, ckv = case
    q, k, v, do = _vjp_inputs(case)
    td = getattr(torch, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap, q_offset=qoff,
              q_chunk=cq, kv_chunk=ckv)
    grads = {}
    for impl in ("cuda", "torch"):
        ts = [torch.from_numpy(x).to(cuda, td).requires_grad_(True)
              for x in (q, k, v)]
        out = t_ops.mha(*ts, impl=impl, **kw)
        out.backward(torch.from_numpy(do).to(cuda, td))
        grads[impl] = [t.grad.cpu() for t in ts]
    for a, b in zip(grads["cuda"], grads["torch"]):
        _close(a, b, VJP_TOL[dtype], VJP_TOL[dtype])


@pytest.mark.cuda
def test_ctypes_wrappers_refuse_autograd(cuda):
    """Every kernel wrapper raises when grad mode is on and an input needs
    a gradient, and runs under ``torch.no_grad``."""
    from repro_torch.kernels.flash_attention.kernel import (
        flash_attention, flash_attention_bwd)
    from repro_torch.kernels.flash_decode.kernel import flash_decode
    from repro_torch.kernels.grouped_gemm.kernel import grouped_gemm
    from repro_torch.kernels.mamba_scan.kernel import mamba_scan
    from repro_torch.kernels.rwkv6_scan.kernel import rwkv6_scan

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, device=cuda).to(dtype)

    q, k = r(1, 16, 4, 64), r(1, 16, 2, 64)
    lengths = torch.full((1,), 16, dtype=torch.int32, device=cuda)
    sizes = torch.tensor([8, 8], dtype=torch.int32, device=cuda)
    f32 = torch.float32
    lse = torch.zeros((1, 16, 4), device=cuda)
    calls = {
        "flash_attention": (lambda a: flash_attention(a, k, k), q),
        "flash_attention_bwd": (lambda a: flash_attention_bwd(
            a, k, k, q, lse, q), q.clone()),
        "flash_decode": (lambda a: flash_decode(a, k, k, lengths),
                         r(1, 1, 4, 64)),
        "grouped_gemm": (lambda a: grouped_gemm(a, sizes, r(2, 64, 32)),
                         r(16, 64)),
        "rwkv6_scan": (lambda a: rwkv6_scan(
            a, a.detach(), a.detach(), torch.rand(1, 8, 2, 16, device=cuda),
            r(2, 16, dtype=f32)), r(1, 8, 2, 16)),
        "mamba_scan": (lambda a: mamba_scan(
            a, torch.rand(1, 8, 16, device=cuda), -torch.rand(16, 4, device=cuda),
            r(1, 8, 4, dtype=f32), r(1, 8, 4, dtype=f32), r(16, dtype=f32)),
            r(1, 8, 16, dtype=f32)),
    }
    for name, (call, x) in calls.items():
        x = x.requires_grad_(True)
        with pytest.raises(RuntimeError, match=f"{name}: the CUDA kernel has "
                                               "no backward"):
            call(x)
        with torch.no_grad():
            call(x)
    torch.cuda.synchronize()


def test_wrappers_check_autograd_before_the_device():
    """On the CPU the refusal comes first, so it is tested here too (the
    wrappers then refuse CPU tensors)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    q = torch.zeros((1, 4, 2, 16), requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, q.detach(), q.detach())
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention(q, q.detach(), q.detach())


def test_reduced_window_binds():
    """The gemma2 case above runs with a window shorter than its sequence,
    so the "l" layers' mask is exercised."""
    _, tcfg = _pair("gemma2-9b")
    assert "l" in tcfg.layer_pattern and tcfg.sliding_window < 16
    assert tcfg.attn_softcap > 0 and tcfg.final_softcap > 0
