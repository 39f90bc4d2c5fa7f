"""Model layer of the PyTorch port against the JAX package: the weight
bridge (``params_from_jax``), ``init_params``' tree and distributions, and
prefill plus decode-step logits on the same weights and ragged inputs.

The MoE feed-forward (single device) is held against ``moe_apply`` and the
dense oracle ``moe_ref``, its capacity drops against JAX's routing.

Logit tolerances: with an fp32 cache the two frameworks compute the same
fp32 arithmetic in another order, so atol = rtol = 1e-4. With the default
bf16 cache, p is rounded to bf16 before the PV product (as in the
reference); an fp32-ulp difference upstream can flip that rounding by one
bf16 ulp (2^-8 relative), so logits of magnitude ~30 (gemma2's final
softcap) may move by a few 1e-3: atol = rtol = 1e-2 there. The recurrent
states (rwkv6, Mamba) stay fp32 whatever the cache dtype.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference; absent on the card's machine
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import decode_step as j_decode_step
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import prefill as j_prefill
from repro_torch import configs as tconfigs
from repro_torch.models import convert
from repro_torch.models import transformer as T

SUPPORTED = ["qwen2-7b", "gemma2-9b", "yi-9b", "qwen2.5-14b", "tiny-dense",
             "rwkv6-7b", "jamba-v0.1-52b", "olmoe-1b-7b",
             "qwen3-moe-30b-a3b", "tiny-moe", "internvl2-2b",
             "seamless-m4t-large-v2"]
# leaves drawn from a truncated normal (the rest are constants)
RANDOM_LEAVES = ("w", "table", "w1", "wg", "w2", "router", "mix_w1",
                 "mix_w2", "decay_w1", "decay_w2", "bonus", "conv_w")


def _stored_in_compute_dtype(key):
    """Where the reference casts a leaf to the compute dtype at every use:
    dense weights, the embedding table and the MoE experts. mamba.py:83
    reads dt_proj.w in fp32, so it stays fp32 with everything else."""
    parent, leaf = key.rsplit("/", 2)[-2:]
    return ((leaf == "w" and parent != "dt_proj") or key == "/embed/table"
            or (parent == "ffn" and leaf in ("w1", "wg", "w2")))


def _cfgs(arch, **kw):
    if arch == "jamba-v0.1-52b":
        kw.setdefault("n_layers", 8)       # one period "mmmmgmmm"
    j = jconfigs.get_config(arch)
    t = tconfigs.get_config(arch)
    if arch.startswith("tiny"):
        return j, t
    return jconfigs.reduced(j, **kw), tconfigs.reduced(t, **kw)


@functools.lru_cache(maxsize=None)
def _jax_params(jcfg):
    """The reference's parameters for ``jcfg`` from PRNGKey(0), made once
    per config (jamba's take seconds to build)."""
    return j_init_params(jax.random.PRNGKey(0), jcfg)


def _np_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def test_registry_is_a_copy():
    """Every field of the JAX package's configs is equal in the port's, and
    each field that only the port has is at its default on every mirrored
    config (the port's own configurations live in the benchmark's files)."""
    assert sorted(tconfigs.REGISTRY) == sorted(jconfigs.REGISTRY)
    defaults = {f.name: f.default
                for f in dataclasses.fields(tconfigs.ModelConfig)}
    port_only = defaults.keys() - {
        f.name for f in dataclasses.fields(jconfigs.ModelConfig)}
    assert port_only == {"mamba_inner_norms"}

    def mirrors(port_cfg, jax_cfg):
        port = vars(port_cfg)
        return ({k: port[k] for k in vars(jax_cfg)} == vars(jax_cfg)
                and all(port[k] == defaults[k] for k in port_only))
    for name, cfg in jconfigs.REGISTRY.items():
        assert mirrors(tconfigs.get_config(name), cfg), name
    assert tconfigs.get_config("qwen2-7b").padded_vocab == 155648
    assert mirrors(tconfigs.reduced(tconfigs.get_config("gemma2-9b")),
                   jconfigs.reduced(jconfigs.get_config("gemma2-9b")))


@pytest.mark.parametrize("arch", SUPPORTED)
def test_params_from_jax_roundtrip(arch):
    jcfg, tcfg = _cfgs(arch)
    tree = _np_tree(_jax_params(jcfg))
    flat = _flat(tree)
    p32 = _flat(convert.params_from_jax(tree, tcfg, device="cpu",
                                        compute_dtype=torch.float32))
    p16 = _flat(convert.params_from_jax(tree, tcfg, device="cpu",
                                        compute_dtype=torch.bfloat16))
    assert set(p32) == set(flat) == set(p16)
    assert ("/lm_head/w" in flat) == (not tcfg.tie_embeddings)
    # init_params stores every leaf as the conversion does
    made = _flat(T.init_params(tcfg, generator=torch.Generator().manual_seed(0),
                               device="cpu", dtype=torch.bfloat16))
    assert set(made) == set(flat)
    for key, ref in flat.items():
        np.testing.assert_array_equal(p32[key].numpy(), ref)
        matrix = _stored_in_compute_dtype(key)
        assert p16[key].dtype == (torch.bfloat16 if matrix else torch.float32)
        assert made[key].dtype == p16[key].dtype, key
        want = (torch.tensor(ref).bfloat16().float().numpy() if matrix
                else ref)
        np.testing.assert_array_equal(p16[key].float().numpy(), want)


@pytest.mark.parametrize("change", ["drop", "add", "rename"])
def test_params_from_jax_rejects_another_tree(change):
    """The bridge walks the port's spec tree: a leaf missing, extra or
    misnamed anywhere in the reference's tree raises, naming the place."""
    jcfg, tcfg = _cfgs("tiny-moe")
    tree = _np_tree(_jax_params(jcfg))
    ffn = tree["blocks"]["sub0"]["ffn"]
    if change == "drop":
        del ffn["router"]
    elif change == "add":
        ffn["extra"] = ffn["router"]
    else:
        ffn["gate"] = ffn.pop("router")
    with pytest.raises(ValueError, match="blocks/sub0/ffn"):
        convert.params_from_jax(tree, tcfg, device="cpu")


def test_unported_archs_raise():
    """Every model of the registry is ported; a layer kind the port lacks
    (here a made-up one) still raises at every entry point."""
    _, tcfg = _cfgs("qwen2-7b", layer_pattern="x")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(NotImplementedError):
        T.init_params(tcfg, generator=gen, device="cpu")
    with pytest.raises(NotImplementedError):
        convert.params_from_jax({}, tcfg, device="cpu")
    with pytest.raises(NotImplementedError):
        T.init_cache(tcfg, 1, 8, device="cpu")


@pytest.mark.parametrize("arch", SUPPORTED)
def test_init_params_tree_and_distributions(arch):
    """Same tree, shapes and per-leaf dtype rule as the JAX ``init_params``
    (full-size shapes from ``jax.eval_shape``; values at reduced size),
    with the reference's truncated-normal scales."""
    jfull = jconfigs.get_config(arch)
    shapes = _flat(jax.eval_shape(
        lambda: j_init_params(jax.random.PRNGKey(0), jfull)))
    meta = _flat(T.init_params(tconfigs.get_config(arch),
                               generator=torch.Generator(),
                               device="meta", dtype=torch.bfloat16))
    assert set(meta) == set(shapes)
    for key, s in shapes.items():
        assert tuple(meta[key].shape) == tuple(s.shape), key

    jcfg, tcfg = _cfgs(arch)
    gen = torch.Generator().manual_seed(0)
    got = _flat(T.init_params(tcfg, generator=gen, device="cpu",
                              dtype=torch.float32))
    ref = _flat(_np_tree(_jax_params(jcfg)))
    sigma = {k: p.stddev for k, p in _flat(T.param_specs(tcfg)).items()}
    for key, r in ref.items():
        g = got[key].numpy()
        assert g.shape == r.shape, key
        if key.rsplit("/", 1)[1] in RANDOM_LEAVES:
            # truncated normal on [-2, 2] sigma: std 0.8796 sigma, the
            # reference's sigma; never past 2 sigma
            assert abs(g.std() / r.std() - 1) < 0.1, key
            assert np.abs(g).max() <= 2 * sigma[key] * (1 + 1e-6), key
        elif key.endswith("/A_log"):
            # log(1..N): XLA's fp32 log of 7 is one ulp from the correctly
            # rounded value that torch gives
            np.testing.assert_allclose(g, r, rtol=2 ** -23, atol=0)
        else:
            np.testing.assert_array_equal(g, r)   # constants: biases, norms


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["qwen2-7b", "gemma2-9b", "rwkv6-7b",
                                  "jamba-v0.1-52b"])
def test_prefill_and_decode_logits_match_jax(arch, cache_dtype):
    kw = {"n_layers": 2} if arch == "qwen2-7b" else {}
    jcfg, tcfg = _cfgs(arch, **kw)
    params = _jax_params(jcfg)
    tparams = convert.params_from_jax(_np_tree(params), tcfg, device="cpu",
                                      compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    B, S, L = 3, 12, 32
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    lens = np.array([12, 5, 9], np.int32)                 # ragged rows
    tol = 1e-4 if cache_dtype == "float32" else 1e-2

    jc = j_init_cache(jcfg, B, L, dtype=getattr(jnp, cache_dtype))
    jl, jc, jlen = j_prefill(params, jcfg, jnp.asarray(toks), jc,
                             lengths=jnp.asarray(lens),
                             compute_dtype=jnp.float32)
    tc = T.init_cache(tcfg, B, L, dtype=getattr(torch, cache_dtype),
                      device="cpu")
    tl, tc, tlen = T.prefill(tparams, tcfg, torch.from_numpy(toks), tc,
                             lengths=torch.from_numpy(lens),
                             compute_dtype=torch.float32)
    assert tl.shape == (B, 1, tcfg.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol, rtol=tol)
    np.testing.assert_array_equal(tlen.numpy(), np.asarray(jlen))
    jlen, tlen = jlen + 1, tlen + 1
    for _ in range(3):
        nxt = rng.integers(0, jcfg.vocab, (B, 1)).astype(np.int32)
        jl, jc, jlen = j_decode_step(params, jcfg, jnp.asarray(nxt), jc, jlen,
                                     compute_dtype=jnp.float32)
        tl, tc, tlen = T.decode_step(tparams, tcfg, torch.from_numpy(nxt), tc,
                                     tlen, compute_dtype=torch.float32)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=tol,
                                   rtol=tol)
    for sub in jc:
        for leaf in jc[sub]:       # k/v, and the fp32 recurrent states
            assert tc[sub][leaf].shape == jc[sub][leaf].shape, (sub, leaf)
            np.testing.assert_allclose(
                tc[sub][leaf].float().numpy(),
                np.asarray(jc[sub][leaf], np.float32), atol=tol, rtol=tol)


def test_padded_vocab_rows_masked():
    jcfg, tcfg = _cfgs("qwen2-7b", n_layers=1, vocab=300)
    assert tcfg.padded_vocab == 512
    params = j_init_params(jax.random.PRNGKey(1), jcfg)
    tparams = convert.params_from_jax(_np_tree(params), tcfg, device="cpu",
                                      compute_dtype=torch.float32)
    toks = np.arange(8, dtype=np.int32)[None]
    jl, _, _ = j_prefill(params, jcfg, jnp.asarray(toks),
                         j_init_cache(jcfg, 1, 16), compute_dtype=jnp.float32)
    tl, _, _ = T.prefill(tparams, tcfg, torch.from_numpy(toks),
                         T.init_cache(tcfg, 1, 16, device="cpu"),
                         compute_dtype=torch.float32)
    assert (tl[..., 300:] == -1e30).all()
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4,
                               rtol=1e-4)


def test_decode_write_index_clamps_like_jax():
    """Write indices outside the cache: JAX's dynamic_update_slice counts a
    negative start from the end and clamps a start past the end to L-1;
    the port maps them the same way instead of writing out of bounds."""
    jcfg, tcfg = _cfgs("qwen2-7b", n_layers=1)
    params = j_init_params(jax.random.PRNGKey(2), jcfg)
    tparams = convert.params_from_jax(_np_tree(params), tcfg, device="cpu",
                                      compute_dtype=torch.float32)
    B, L = 3, 8
    jc = j_init_cache(jcfg, B, L, dtype=jnp.float32)
    tc = T.init_cache(tcfg, B, L, dtype=torch.float32, device="cpu")
    lens = np.array([L + 3, 0, -2], np.int32)   # past the end, negative
    nxt = np.array([[5], [7], [9]], np.int32)
    jl, jc, _ = j_decode_step(params, jcfg, jnp.asarray(nxt), jc,
                              jnp.asarray(lens), compute_dtype=jnp.float32)
    tl, tc, _ = T.decode_step(tparams, tcfg, torch.from_numpy(nxt), tc,
                              torch.from_numpy(lens),
                              compute_dtype=torch.float32)
    for kv in ("k", "v"):
        np.testing.assert_allclose(tc["sub0"][kv].numpy(),
                                   np.asarray(jc["sub0"][kv]), atol=1e-5)
    written = tc["sub0"]["k"][0].abs().sum(dim=(-1, -2)) > 0   # [B, L]
    assert written.sum() == B
    assert written[0, L - 1] and written[1, L - 1] and written[2, L - 3]


# ------------------------------------------------------------ MoE

def _moe_case(arch, capacity_factor, seed):
    """A reduced config's MoE params from JAX and numpy inputs [2, 16, D]."""
    from repro.models.moe import init_moe
    jcfg, tcfg = _cfgs(arch, capacity_factor=capacity_factor)
    p = init_moe(jax.random.PRNGKey(seed), jcfg)
    x = np.random.default_rng(seed).standard_normal(
        (2, 16, jcfg.d_model)).astype(np.float32) * 0.5
    tp = {k: torch.from_numpy(np.array(v, np.float32)) for k, v in p.items()}
    return jcfg, tcfg, p, tp, x


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-moe-30b-a3b",
                                  "jamba-v0.1-52b"])
def test_moe_matches_jax_and_dense_oracle(arch):
    """High capacity (no drops): the port's MoE against ``moe_apply`` and
    both dense oracles; fp32 sums in another order, atol 1e-5, rtol 1e-4
    (``moe_ref`` vs the dispatch path: the reference's 1e-4 / 1e-3)."""
    from repro.models.moe import moe_apply, moe_ref
    from repro_torch.models import moe as tmoe
    jcfg, tcfg, p, tp, x = _moe_case(arch, 8.0, seed=0)
    out = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg,
                         compute_dtype=torch.float32)
    want = moe_apply(p, jnp.asarray(x), jcfg, compute_dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-4)
    ref = tmoe.moe_ref(tp, torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(ref.numpy(), np.asarray(moe_ref(p, jnp.asarray(x),
                                                                 jcfg)),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "jamba-v0.1-52b"])
def test_moe_capacity_drops_match_jax(arch):
    """capacity_factor 0.5: tokens are dropped; the dropped (token, expert)
    pairs are those of the reference's routing (fp32 router, top-k, stable
    argsort by expert, rank >= C), and the outputs match ``moe_apply``."""
    from repro.models.moe import _capacity, moe_apply
    from repro_torch.models import moe as tmoe
    jcfg, tcfg, p, tp, x = _moe_case(arch, 0.5, seed=1)
    xt = x.reshape(-1, jcfg.d_model)
    T, K = xt.shape[0], jcfg.top_k
    # the reference's routing (repro/models/moe.py:70-84) on its arrays
    probs = jax.nn.softmax(jnp.asarray(xt) @ p["router"], axis=-1)
    _, eidx = jax.lax.top_k(probs, K)
    e_flat = eidx.reshape(-1)
    order = jnp.argsort(e_flat)
    counts = jnp.bincount(e_flat, length=jcfg.n_experts)
    rank = jnp.arange(T * K) - (jnp.cumsum(counts) - counts)[e_flat[order]]
    t_flat = np.repeat(np.arange(T), K)[np.asarray(order)]
    C = _capacity(T, jcfg)
    want = {(int(t), int(e)) for t, e, r in zip(
        t_flat, np.asarray(e_flat[order]), np.asarray(rank)) if r >= C}

    e_s, t_s, _, trank, keep = tmoe._route(torch.from_numpy(xt), tp["router"],
                                           tcfg)
    got = {(int(t), int(e)) for t, e, k in zip(t_s, e_s, keep) if not k}
    assert tmoe._capacity(T, tcfg) == C
    assert want and got == want
    np.testing.assert_array_equal(trank.numpy(), np.asarray(rank))
    out = tmoe.moe_apply(tp, torch.from_numpy(x), tcfg,
                         compute_dtype=torch.float32)
    ref = moe_apply(p, jnp.asarray(x), jcfg, compute_dtype=jnp.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-4)
