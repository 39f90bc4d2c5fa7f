"""Sharding of the PyTorch port against the JAX package's: the planner, the
logical axes of every parameter, specs and placements, the decode partials
at a position offset, and (on 8 gloo ranks at (2, 2, 2)) the int8 cross-pod
gradient compression, plus the collective recorder under the router's
isolation rule.

The planner and the axes are compared exactly (strategy, bindings, notes,
every spec). ``_decode_partials(pos_offset=...)`` is held to the
reference's at fp32 (1e-5; readings <= 1.9e-6 on unnormalised sums of up
to 16 rows), slices with no valid row included, and the slices' partials
combined to the whole-cache decode (1e-5; reading 1.8e-7). The
compression is held to a numpy restatement of
``repro/training/step.py:90-98`` (the reference's ``grad_compress_pod``
path fails on JAX 0.9 with "unexpected keyword argument 'auto'", so it has
no JAX oracle): q and the int32 totals exactly, the mean and the error
feedback to 1e-6 (readings 0.0: the same fp32 operations in the same
order).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference; absent on the card's machine
import jax.numpy as jnp

from repro.compat import abstract_mesh as j_abstract_mesh
from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import get_shape as j_get_shape
from repro.kernels.flash_attention import ops as j_ops
from repro.models import param_axes as j_param_axes
from repro.sharding.api import ShardingRules as JRules
from repro.sharding.planner import plan_for as j_plan_for
from repro_torch.configs import REGISTRY, get_shape
from repro_torch.core import IsolationViolation
from repro_torch.kernels.flash_attention import ops as t_ops
from repro_torch.launch.mesh import make_abstract_production_mesh
from repro_torch.models import param_axes
from repro_torch.sharding import ShardingRules, abstract_mesh, validate_groups
from repro_torch.sharding.planner import plan_for
from torch.distributed.tensor import Replicate, Shard

REPO = Path(__file__).resolve().parents[1]
MESH1 = abstract_mesh((16, 16), ("data", "model"))
MESH2 = abstract_mesh((2, 16, 16), ("pod", "data", "model"))
J_MESHES = {"1pod": j_abstract_mesh((16, 16), ("data", "model")),
            "2pod": j_abstract_mesh((2, 16, 16), ("pod", "data", "model"))}
MESHES = {"1pod": MESH1, "2pod": MESH2}
SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def _axes_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _axes_leaves(tree[k], f"{prefix}/{k}")
        return out
    return [(prefix, tuple(tree))]


# ------------------------------------------------------------ the planner

@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_plan_matches_reference(arch, shape, mesh):
    """Strategy, every binding, the notes and the spec of every parameter
    leaf, for every registry config, shape and production mesh."""
    j = j_plan_for(J_REGISTRY[arch], j_get_shape(shape), J_MESHES[mesh])
    t = plan_for(REGISTRY[arch], get_shape(shape), MESHES[mesh])
    assert t.strategy == j.strategy
    assert t.rules.bindings == j.rules.bindings
    assert t.notes == j.notes
    for path, names in _axes_leaves(param_axes(REGISTRY[arch])):
        assert t.rules.spec(names) == tuple(j.rules.spec(names)), path


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_param_axes_match_reference(arch):
    def norm(tree):
        if isinstance(tree, dict):
            return {k: norm(v) for k, v in tree.items()}
        return tuple(tree)
    assert norm(param_axes(REGISTRY[arch])) == norm(
        j_param_axes(J_REGISTRY[arch]))


def test_abstract_production_meshes():
    assert make_abstract_production_mesh().shape == {"data": 16, "model": 16}
    two = make_abstract_production_mesh(multi_pod=True)
    assert two.axis_names == ("pod", "data", "model")
    with pytest.raises(ValueError):
        abstract_mesh((2, 2), ("data",))


def _spec_placements(spec, axis_order):
    """A reference PartitionSpec as DTensor placements (the rule the
    port's ``ShardingRules.placements`` implements)."""
    out = [Replicate()] * len(axis_order)
    for dim, part in enumerate(spec):
        for a in ((part,) if isinstance(part, str) else (part or ())):
            out[axis_order.index(a)] = Shard(dim)
    return tuple(out)


@pytest.mark.parametrize("arch", ["qwen2-7b", "jamba-v0.1-52b",
                                  "seamless-m4t-large-v2", "internvl2-2b"])
def test_step_shardings_match_reference(arch):
    """``train_shardings`` and ``serve_shardings``: every leaf's placements
    are the reference's NamedSharding spec, read as placements."""
    from repro.sharding.planner import serve_shardings as j_serve
    from repro.sharding.planner import train_shardings as j_train
    from repro_torch.sharding.planner import serve_shardings, train_shardings
    order = MESH2.axis_names
    for kind, shape in (("train", "train_4k"), ("serve", "decode_32k")):
        j = j_plan_for(J_REGISTRY[arch], j_get_shape(shape), J_MESHES["2pod"])
        t = plan_for(REGISTRY[arch], get_shape(shape), MESH2)
        jt = (j_train if kind == "train" else j_serve)(j, J_REGISTRY[arch])
        tt = (train_shardings if kind == "train" else serve_shardings)(
            t, REGISTRY[arch])

        def walk(a, b, path):
            if isinstance(b, dict):
                assert set(a) >= set(b), path
                for k in b:
                    walk(a[k], b[k], f"{path}/{k}")
                return
            assert a == _spec_placements(b.spec, order), path
        walk(tt, jt, kind)


@pytest.mark.parametrize("arch", sorted(REGISTRY))
def test_meta_specs_match_reference_shapes(arch):
    """``launch.specs`` (meta tensors, nothing allocated) against the
    reference's ShapeDtypeStructs: every parameter, optimizer, cache and
    input leaf has the reference's shape."""
    from repro.launch import specs as j_specs
    from repro_torch.launch import specs as t_specs
    cfg, jcfg = REGISTRY[arch], J_REGISTRY[arch]
    pairs = [(t_specs.param_specs(cfg), j_specs.param_specs(jcfg))]
    pairs.append((t_specs.opt_specs(pairs[0][0]),
                  j_specs.opt_specs(pairs[0][1])))
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        pairs.append((t_specs.input_specs(cfg, get_shape(shape)),
                      j_specs.input_specs(jcfg, j_get_shape(shape))))
    pairs.append((t_specs.cache_specs(cfg, get_shape("decode_32k")),
                  j_specs.cache_specs(jcfg, j_get_shape("decode_32k"))))

    def walk(t, j, path):
        if isinstance(j, dict):
            assert set(t) == set(j), path
            for k in j:
                walk(t[k], j[k], f"{path}/{k}")
            return
        assert t.device.type == "meta", path
        assert tuple(t.shape) == tuple(j.shape), path
    for t, j in pairs:
        walk(t, j, "")


def test_production_mesh_needs_its_ranks():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(RuntimeError, match="512 ranks"):
        make_production_mesh(multi_pod=True)


# twins of tests/test_sharding.py

def test_heads_divisible_uses_tp_heads():
    plan = plan_for(REGISTRY["yi-9b"], get_shape("train_4k"), MESH1)
    assert plan.strategy == "tp_heads"
    assert plan.rules.bindings["heads"] == "model"


def test_heads_indivisible_falls_back_to_context():
    for arch in ("qwen2-7b", "qwen2.5-14b"):
        plan = plan_for(REGISTRY[arch], get_shape("train_4k"), MESH1)
        assert plan.strategy == "context", arch
        assert plan.rules.bindings["heads"] is None
        assert plan.rules.bindings["attn_seq"] == "model"
        assert any("context-parallel" in n for n in plan.notes)


def test_decode_strategy_shards_cache_seq():
    plan = plan_for(REGISTRY["qwen2-7b"], get_shape("decode_32k"), MESH1)
    assert plan.strategy == "decode"
    assert plan.rules.bindings["cache_seq"] == "model"
    assert plan.rules.bindings["embed"] == "model"
    assert plan.rules.bindings["seq"] is None


def test_train_uses_fsdp_embed_on_data():
    plan = plan_for(REGISTRY["jamba-v0.1-52b"], get_shape("train_4k"), MESH1)
    assert plan.rules.bindings["embed"] == "data"


def test_batch_axes_multi_pod():
    plan = plan_for(REGISTRY["qwen2-7b"], get_shape("train_4k"), MESH2)
    assert plan.rules.bindings["batch"] == ("pod", "data")


def test_batch_of_one_not_sharded():
    plan = plan_for(REGISTRY["rwkv6-7b"], get_shape("long_500k"), MESH1)
    assert plan.rules.bindings["batch"] is None
    assert any("batch replicated" in n for n in plan.notes)


def test_moe_expert_axis():
    plan = plan_for(REGISTRY["qwen3-moe-30b-a3b"], get_shape("train_4k"),
                    MESH1)
    assert plan.rules.bindings["expert"] == "model"
    assert plan.rules.bindings["moe_tokens"] == ("data", "model")


# ------------------------------------------------- specs and placements

@pytest.mark.parametrize("names", [
    ("batch", "seq", "mlp"),          # "model" twice: the second use drops
    ("batch", None, None),            # trailing Nones trimmed
    ("seq", "batch", "embed", None),
    ("mlp", "mlp", "vocab"),
    ("batch",),
    (),
])
def test_spec_dedupes_and_trims_like_reference(names):
    bindings = {"batch": ("pod", "data"), "seq": "model", "mlp": "model",
                "embed": "data", "vocab": "model"}
    j = JRules(J_MESHES["2pod"], bindings)
    t = ShardingRules(MESH2, bindings)
    assert t.spec(names) == tuple(j.spec(names))


def test_placements_map_mesh_dims_to_tensor_dims():
    rules = ShardingRules(MESH2, {"batch": ("pod", "data"), "seq": "model",
                                  "mlp": "model"})
    # batch on (pod, data): a Shard(0) for each, in the mesh's order
    assert rules.placements(("batch", "seq")) == (Shard(0), Shard(0),
                                                  Shard(1))
    # "model" used by seq, dropped for mlp
    assert rules.placements(("batch", "seq", "mlp")) == (Shard(0), Shard(0),
                                                         Shard(1))
    assert rules.placements((None, "mlp")) == (Replicate(), Replicate(),
                                               Shard(1))
    assert rules.placements(()) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="order"):
        ShardingRules(MESH2, {"batch": ("data", "pod")}).placements(
            ("batch",))
    with pytest.raises(ValueError, match="not in the mesh"):
        ShardingRules(MESH1, {"batch": "pod"}).placements(("batch",))


# ----------------------------------------------- decode partials at an offset

def _decode_inputs(seed, B=3, L=64, H=8, KV=2, D=16):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    k = rng.standard_normal((B, L, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, L, KV, D)).astype(np.float32)
    lengths = np.array([40, 3, 64], np.int32)     # row 1: one slice only
    return q, k, v, lengths


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (20, 0.0), (20, 50.0)])
def test_decode_partials_at_offset_match_reference(window, softcap):
    """Each 16-position slice of a 64-position cache at its global offset,
    against the reference's ``_decode_partials(pos_offset=...)``; slices
    past a row's length (row 1 beyond 16, row 0 at 48) give m -1e30, l 0."""
    q, k, v, lengths = _decode_inputs(0)
    kw = dict(window=window, softcap=softcap, scale=None, kv_chunk=8)
    for off in range(0, 64, 16):
        sl = slice(off, off + 16)
        ja, jm, jl = j_ops._decode_partials(
            jnp.asarray(q), jnp.asarray(k[:, sl]), jnp.asarray(v[:, sl]),
            jnp.asarray(lengths), pos_offset=off, **kw)
        ta, tm, tl = t_ops._decode_partials(
            torch.from_numpy(q), torch.from_numpy(k[:, sl]),
            torch.from_numpy(v[:, sl]), torch.from_numpy(lengths),
            pos_offset=off, **kw)
        for t, j in ((ta, ja), (tm, jm), (tl, jl)):
            print(f"offset {off}: {float(np.abs(t.numpy() - np.asarray(j)).max())}")
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                       rtol=1e-5, err_msg=f"offset {off}")
        if off >= 16:
            assert bool((tl[1] == 0).all()) and bool((tm[1] == -1e30).all())


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (20, 50.0)])
def test_decode_partials_combine_to_whole_cache(window, softcap):
    """The slices' partials, max-rescaled and summed (the cross-rank
    combine of ``_decode_mha_seq_sharded``), give the whole-cache decode."""
    q, k, v, lengths = (torch.from_numpy(a) for a in _decode_inputs(1))
    kw = dict(window=window, softcap=softcap, scale=None, kv_chunk=8)
    parts = [t_ops._decode_partials(q, k[:, o:o + 16], v[:, o:o + 16],
                                    lengths, pos_offset=o, **kw)
             for o in range(0, 64, 16)]
    m_g = torch.stack([p[1] for p in parts]).amax(0)
    corr = [torch.exp(p[1] - m_g) for p in parts]
    l_g = sum(p[2] * c for p, c in zip(parts, corr))
    acc_g = sum(p[0] * c[..., None] for p, c in zip(parts, corr))
    out = (acc_g / (l_g[..., None] + 1e-30)).reshape(q.shape)
    whole = t_ops.decode_mha(q, k, v, lengths, impl="torch", **{
        n: kw[n] for n in ("window", "softcap", "scale")})
    print("combined vs whole:", float((out - whole).abs().max()))
    np.testing.assert_allclose(out.numpy(), whole.numpy(), atol=1e-5,
                               rtol=1e-5)


def test_checkpoint_recomputes_under_the_rules_on_another_thread():
    """On the card the autograd engine recomputes a checkpointed block on
    a device thread of its own, where the rules' context variable is
    unset; the port's ``checkpoint`` re-enters the rules active at the
    forward. Here the backward runs on a fresh thread to the same end."""
    import threading
    from repro_torch.sharding.api import active_rules, checkpoint, use_rules
    seen = []

    def body(x):
        seen.append(active_rules())
        return x * x                   # saves x: the backward recomputes

    rules = ShardingRules(MESH1, {"batch": "data"})
    x = torch.ones(3, requires_grad=True)
    with use_rules(rules):
        y = checkpoint(body, x).sum()
    t = threading.Thread(target=y.backward)
    t.start()
    t.join()
    assert seen == [rules, rules]          # forward, then the recompute
    assert torch.equal(x.grad, torch.full((3,), 2.0))   # d(x^2)/dx at 1


# ------------------------------------------------------ isolation rule

def test_validate_groups_uses_the_router_rule():
    assert validate_groups([frozenset({0, 1}), frozenset({2, 3})],
                           range(4)) == 2
    assert validate_groups([], range(4)) == 0
    with pytest.raises(IsolationViolation, match=r"\[4\]"):
        validate_groups([frozenset({0, 1}), frozenset({0, 4})], range(4))


# Two tenant slices of 8 ranks, 0-7 and 8-15 (two-digit ranks included).
SLICES = {"a": range(0, 8), "b": range(8, 16)}


@pytest.mark.parametrize("groups,inside,outside", [
    ([{0, 1, 2, 3}, {4, 5, 6, 7}, {0, 4}], "a", "b"),      # in slice a
    ([{8, 9}, {10, 11, 12, 13, 14, 15}, {15}], "b", "a"),  # in slice b
    ([set(range(8, 16))], "b", "a"),                      # all of slice b
    ([{0, 1}, {7, 8}], None, "ab"),                        # straddles both
    ([set(range(16))], None, "ab"),                        # the whole world
], ids=["in-a", "in-b", "all-of-b", "straddling", "world"])
def test_validate_groups_accepts_in_slice_and_rejects_straddling(
        groups, inside, outside):
    """Each group set through the router's parser: every group is counted
    (a parser that skipped one would raise, not pass), groups inside a
    slice pass it, and a slice refuses any group that reaches beyond it."""
    groups = [frozenset(g) for g in groups]
    if inside:
        assert validate_groups(groups, SLICES[inside]) == len(groups)
    for name in outside:
        with pytest.raises(IsolationViolation,
                           match="outside the tenant slice"):
            validate_groups(groups, SLICES[name])


def test_validate_groups_raises_when_the_parser_reads_too_few(monkeypatch):
    """A router whose parser no longer reads the lines ``validate_groups``
    writes must not let the groups pass unchecked."""
    from repro_torch.core.router import MeshRouter
    monkeypatch.setattr(MeshRouter, "_COLLECTIVE_RE",
                        re.compile(r"(?!)(x)(y)"))   # matches nothing
    with pytest.raises(RuntimeError, match="read 0 of 2"):
        validate_groups([frozenset({0, 1}), frozenset({8, 9})], range(16))


# -------------------------------------- cross-pod compression, 8 gloo ranks

COMPRESS_SCRIPT = r"""
import numpy as np
import torch
from repro_torch.launch.spmd import spawn
OUT = %(out)r


def rank(r, n):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.models import init_params, param_axes
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding.api import record_collectives, use_rules
    from repro_torch.sharding.planner import plan_for
    from repro_torch.training import (OptimizerConfig, make_opt_state,
                                      make_train_step)
    from repro_torch.training.grad_compress import (compressed_pod_mean,
                                                    init_error_state,
                                                    reduce_one)
    from repro_torch.training.optimizer import opt_state_axes
    from repro_torch.training.step import pod_local_grads

    mesh = init_device_mesh("cpu", (2, 2, 2),
                            mesh_dim_names=("pod", "data", "model"))
    pod = mesh.get_local_rank("pod")
    out = {"pod": pod}
    # compressed_pod_mean on pod-local plain tensors, a nonzero residual
    rng = np.random.default_rng(100 + pod)
    g = {"w": rng.standard_normal((6, 5)).astype(np.float32),
         "b": {"x": (rng.standard_normal(7) * 1e-3).astype(np.float32)}}
    e = {"w": (rng.standard_normal((6, 5)) * 1e-2).astype(np.float32),
         "b": {"x": np.zeros(7, np.float32)}}
    tg = {"w": torch.from_numpy(g["w"]), "b": {"x": torch.from_numpy(g["b"]["x"])}}
    te = {"w": torch.from_numpy(e["w"]), "b": {"x": torch.from_numpy(e["b"]["x"])}}
    mean, ef = compressed_pod_mean(tg, te, mesh)
    _, _, q, total = reduce_one(tg["w"], te["w"], mesh)
    out.update(g=g["w"], e=e["w"], gb=g["b"]["x"], mean=mean["w"].numpy(),
               ef=ef["w"].numpy(), meanb=mean["b"]["x"].numpy(),
               efb=ef["b"]["x"].numpy(), q=q.numpy(), total=total.numpy())

    # the train step with grad_compress_pod on a (pod, data, model) mesh
    cfg = reduced(REGISTRY["yi-9b"], d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=16, d_ff=128, vocab=256, n_layers=2)
    plan = plan_for(cfg, ShapeConfig("t", 32, 8, "train"), mesh)
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, generator=gen, device="cpu", dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab, (8, 32), generator=gen,
                           dtype=torch.int32)
    batch = {"tokens": tokens, "mask": torch.ones(8, 32)}
    axes = param_axes(cfg)
    p = plan.distribute(params, axes)
    o = plan.distribute(make_opt_state(params, grad_compress_pod=True),
                        dict(opt_state_axes(axes), ef=axes))
    with use_rules(plan.rules):
        loss, _, grads = pod_local_grads(cfg, plan.rules, p, batch)
        with record_collectives() as groups:
            p, o, m = make_train_step(cfg, OptimizerConfig(), mesh=mesh,
                                      grad_compress_pod=True)(p, o, batch)
    leaf = ("blocks", "sub0", "ffn", "wi", "w")

    def get(t):
        for k in leaf:
            t = t[k]
        return t.full_tensor().numpy()     # this pod's whole tensor
    out.update(step_g=get(grads), step_ef=get(o["ef"]),
               pod_loss=float(loss.full_tensor()),
               loss=float(m["loss"]), ranks=sorted({tuple(sorted(x))
                                                   for x in groups}))
    return out


if __name__ == "__main__":
    res = spawn(rank, 8)
    np.save(OUT, np.array(res, dtype=object), allow_pickle=True)
"""


@pytest.fixture(scope="module")
def compress(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("compress")
    out, script = tmp / "out.npy", tmp / "compress.py"
    script.write_text(COMPRESS_SCRIPT % {"out": str(out)})   # spawned ranks
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))     # import it
    res = subprocess.run([sys.executable, str(script)],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return list(np.load(out, allow_pickle=True))


def _restated(gs, es):
    """repro/training/step.py:90-98 in numpy fp32 over the pods' (g, e)."""
    gf = [g.astype(np.float32) + e for g, e in zip(gs, es)]
    smax = max(np.float32(np.max(np.abs(x))) / np.float32(127.0)
               + np.float32(1e-30) for x in gf)
    q = [np.clip(np.round(x / smax), -127, 127).astype(np.int8) for x in gf]
    total = sum(x.astype(np.int32) for x in q)
    mean = total.astype(np.float32) * smax / np.float32(len(gs))
    return q, total, mean, [x - qq.astype(np.float32) * smax
                            for x, qq in zip(gf, q)]


def test_compressed_pod_mean_matches_restatement(compress):
    by_pod = {r["pod"]: r for r in compress}
    q, total, mean, ef = _restated([by_pod[p]["g"] for p in (0, 1)],
                                   [by_pod[p]["e"] for p in (0, 1)])
    print("compressed_pod_mean: mean", max(float(np.abs(r["mean"] - mean)
                                               .max()) for r in compress),
          "ef", max(float(np.abs(r["ef"] - ef[r["pod"]]).max())
                    for r in compress))
    for r in compress:
        np.testing.assert_array_equal(r["q"], q[r["pod"]])
        np.testing.assert_array_equal(r["total"], total)
        np.testing.assert_allclose(r["mean"], mean, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(r["ef"], ef[r["pod"]], atol=1e-6,
                                   rtol=1e-6)
    # a leaf whose residual starts at zero, small values
    _, _, meanb, efb = _restated([by_pod[p]["gb"] for p in (0, 1)],
                                 [np.zeros(7, np.float32)] * 2)
    for r in compress:
        np.testing.assert_allclose(r["meanb"], meanb, atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(r["efb"], efb[r["pod"]], atol=1e-6,
                                   rtol=1e-6)


def test_grad_compress_pod_step_matches_restatement(compress):
    """The step's new residual is the restatement's from the pods' own
    gradients (``pod_local_grads``, the gradient the step computes on each
    pod's half of the batch on its (data, model) sub-mesh); the loss is
    the pods' mean; every collective of the step stays in the 8 ranks."""
    by_pod = {r["pod"]: r for r in compress}
    gs = [by_pod[p]["step_g"] for p in (0, 1)]
    _, _, _, ef = _restated(gs, [np.zeros_like(g) for g in gs])
    print("grad_compress_pod step: ef", max(float(np.abs(
        r["step_ef"] - ef[r["pod"]]).max()) for r in compress))
    for r in compress:
        np.testing.assert_allclose(r["step_ef"], ef[r["pod"]], atol=1e-6,
                                   rtol=1e-6)
        want = (by_pod[0]["pod_loss"] + by_pod[1]["pod_loss"]) / 2
        assert abs(r["loss"] - want) < 1e-6
    # the pods' halves of the batch differ, so do their gradients
    assert np.abs(gs[0] - gs[1]).max() > 1e-4
    groups = {tuple(g) for r in compress for g in r["ranks"]}
    assert {(0, 4), (1, 5)} <= groups          # the int8 sums over "pod"
    assert all(len(g) in (2, 8) for g in groups)
