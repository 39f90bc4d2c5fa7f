"""The port's sharded train step on 8 CPU ranks against the JAX package's.

One JAX subprocess (8 host devices, ``XLA_FLAGS`` set there only, the mesh
built with ``AxisType.Auto`` axes: with JAX 0.9's default ``Explicit``
axes the reference's ``with_sharding_constraint`` refuses the mesh, which
is why ``tests/test_sharded_exec.py`` fails) runs the reference's train
step sharded on a (2, 4) ("data", "model") mesh, and in the same jit the
gradient of every leaf; one port subprocess runs ``compute_grads`` and
``make_train_step(mesh=...)`` on 8 gloo ranks (``launch.spmd.spawn``) on
the same (2, 4) mesh, then both on one device. Same inputs: the
reference's initial parameters for the configs of
``tests/test_sharded_exec.py:31-33`` and numpy-seeded tokens. The two
subprocesses run at once.

The step is held to the reference's own bounds
(``tests/test_sharded_exec.py:76-77``): loss within 5e-3 and every
parameter within 5e-2 after one step, and the gradient norm within 2e-2
relative. These alone check little of the backward: the first step's
warm-up learning rate (3e-6) moves every parameter by about that much
whatever its gradient. So the gradients are held leaf by leaf, at fp32
compute (the step's bf16 compute lets the MoE archs' routers meet
near-ties that JAX and torch round apart; at fp32 both route alike), as
||port - reference|| / ||reference|| per leaf, within ``GRAD_TOL`` = 1e-4.
Readings on the CPU: against the JAX sharded gradients <= 7.2e-7 for the
dense archs and olmoe-1b-7b, 1.8e-5 for jamba-v0.1-52b (its ``A_log``;
the oracle there is the exact scan, ``impl="ref"``, as in
``tests/test_torch_train.py``); the dense archs' against the port's
single-device gradients <= 6.6e-7. A planted fault, the norm scales'
gradients left unreduced over "model", reads 0.80-0.93 on the worst leaf
of every arch. The step's readings against the JAX sharded step: loss
4.6e-5 (yi-9b), 2.0e-5 (qwen2-7b), 3.2e-4 (olmoe-1b-7b), 1.1e-3
(jamba-v0.1-52b); parameters <= 6.2e-6; gradient norm <= 2.1e-4
relative. Against the port's single-device step (the dense archs; a
sharded MoE drops tokens by each shard's own capacity,
``repro/models/moe.py:46-48``, by design): loss <= 2.7e-5, parameters
<= 6.1e-6.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")   # the reference; absent on the card's machine

from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import reduced as j_reduced
from repro.models import init_params as j_init_params

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["yi-9b", "qwen2-7b", "olmoe-1b-7b", "jamba-v0.1-52b"]
DENSE = ["yi-9b", "qwen2-7b"]
GRAD_TOL = 1e-4      # per leaf, relative: sound <= 1.8e-5, planted fault >= 0.80
# jamba's gradients through the reference's chunked Mamba scan differ from
# its exact recurrence (ROADMAP.md section 3, reference facts)
GRAD_ORACLE_IMPL = {"jamba-v0.1-52b": "ref"}


def small(registry, reduce, arch):
    base = registry[arch]
    return reduce(base, d_model=64, n_heads=4,
                  n_kv_heads=2 if base.n_kv_heads < base.n_heads else 4,
                  head_dim=16, d_ff=128, vocab=256)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


# Both scripts read init.npz ("<arch>|<leaf path>" -> array, "<arch>|tokens")
# and write out_<side>.npz ("<arch>|loss", "<arch>|<leaf path>", ...).
COMMON = r"""
import sys
import numpy as np
ARCHS = %(archs)r
GRAD_ORACLE_IMPL = %(grad_impl)r
DIR = %(dir)r
init = dict(np.load(DIR + "/init.npz"))


def tree(arch):
    out = {}
    for key, val in init.items():
        a, path = key.split("|", 1)
        if a != arch or path == "tokens":
            continue
        node = out
        parts = path.strip("/").split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def flat(t, prefix=""):
    if isinstance(t, dict):
        o = {}
        for k, v in t.items():
            o.update(flat(v, prefix + "/" + k))
        return o
    return {prefix: t}


def small(registry, reduce, arch):
    base = registry[arch]
    return reduce(base, d_model=64, n_heads=4,
                  n_kv_heads=2 if base.n_kv_heads < base.n_heads else 4,
                  head_dim=16, d_ff=128, vocab=256)
"""

JAX_SCRIPT = COMMON + r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import REGISTRY, reduced
from repro.models import loss_fn
from repro.models.config import ShapeConfig
from repro.sharding.api import use_rules
from repro.sharding.planner import plan_for, train_shardings
from repro.training import OptimizerConfig, make_opt_state, make_train_step

mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
res = {}
for arch in ARCHS:
    cfg = small(REGISTRY, reduced, arch)
    params = jax.tree.map(jnp.asarray, tree(arch))
    batch = {"tokens": jnp.asarray(init[arch + "|tokens"]),
             "mask": jnp.ones((8, 64), jnp.float32)}
    plan = plan_for(cfg, ShapeConfig("t", 64, 8, "train"), mesh)
    sh = train_shardings(plan, cfg)

    def loss_of(params, batch):     # at fp32 compute, on the masters
        return loss_fn(params, batch, cfg, remat=True,
                       compute_dtype=jnp.float32,
                       impl=GRAD_ORACLE_IMPL.get(arch))

    with use_rules(plan.rules), mesh:
        step = make_train_step(cfg, OptimizerConfig(), mesh=mesh)

        def both(params, opt, batch):   # the step and its gradients, one jit
            return (step(params, opt, batch),
                    jax.grad(loss_of, has_aux=True)(params, batch)[0])

        fn = jax.jit(both, in_shardings=(sh["params"], sh["opt"],
                                         {k: sh["batch"][k] for k in batch}))
        (p, _, m), g = fn(params, make_opt_state(params), batch)
    res[arch + "|loss"] = np.float32(m["loss"])
    res[arch + "|grad_norm"] = np.float32(m["grad_norm"])
    for k, v in flat(jax.tree.map(np.asarray, p)).items():
        res[arch + "|" + k] = np.asarray(v, np.float32)
    for k, v in flat(jax.tree.map(np.asarray, g)).items():
        res[arch + "|grad|" + k] = np.asarray(v, np.float32)
np.savez(DIR + "/out_jax.npz", **res)
"""

PORT_SCRIPT = COMMON + r"""
import functools
import torch
from repro_torch.launch.spmd import spawn


def fp32_grads(cfg, params, batch):
    # compute_grads at fp32 compute: its bf16 cast of the masters and
    # loss_fn's compute dtype switched to fp32 for this call only, as
    # tests/test_torch_encdec.py does for the train step
    from repro_torch.training import step as t_step
    saved = t_step._to_compute, t_step.model_loss_fn
    t_step._to_compute = lambda p: p
    t_step.model_loss_fn = functools.partial(saved[1],
                                             compute_dtype=torch.float32)
    try:
        return t_step.compute_grads(cfg, params, batch)[2]
    finally:
        t_step._to_compute, t_step.model_loss_fn = saved


def rank(r, n):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.models import param_axes
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.convert import params_from_jax
    from repro_torch.sharding.api import use_rules
    from repro_torch.sharding.planner import plan_for
    from repro_torch.training import (OptimizerConfig, make_opt_state,
                                      make_train_step)
    from repro_torch.training.optimizer import opt_state_axes

    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    res = {}
    for arch in ARCHS:
        cfg = small(REGISTRY, reduced, arch)
        params = params_from_jax(tree(arch), cfg, device="cpu",
                                 compute_dtype=torch.float32)
        plan = plan_for(cfg, ShapeConfig("t", 64, 8, "train"), mesh)
        axes = param_axes(cfg)
        p = plan.distribute(params, axes)
        o = plan.distribute(make_opt_state(params), opt_state_axes(axes))
        batch = {"tokens": torch.from_numpy(init[arch + "|tokens"]),
                 "mask": torch.ones(8, 64)}
        with use_rules(plan.rules):
            g = fp32_grads(cfg, p, batch)
            p, o, m = make_train_step(cfg, OptimizerConfig(), mesh=mesh)(
                p, o, batch)
        res[arch + "|loss"] = np.float32(m["loss"].full_tensor())
        res[arch + "|grad_norm"] = np.float32(m["grad_norm"].full_tensor())
        for k, v in flat(p).items():
            res[arch + "|" + k] = v.full_tensor().float().numpy()
        for k, v in flat(g).items():
            res[arch + "|grad|" + k] = v.full_tensor().float().numpy()
    return res if r == 0 else None


if __name__ == "__main__":
    res = spawn(rank, 8)[0]
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.models.convert import params_from_jax
    from repro_torch.training import (OptimizerConfig, make_opt_state,
                                      make_train_step)
    for arch in ARCHS:      # the port's single-device step, after the ranks
        cfg = small(REGISTRY, reduced, arch)
        params = params_from_jax(tree(arch), cfg, device="cpu",
                                 compute_dtype=torch.float32)
        batch = {"tokens": torch.from_numpy(init[arch + "|tokens"]),
                 "mask": torch.ones(8, 64)}
        g = fp32_grads(cfg, params, batch)
        for k, v in flat(g).items():
            res[arch + "|single|grad|" + k] = v.float().numpy()
        p, _, m = make_train_step(cfg, OptimizerConfig())(
            params, make_opt_state(params), batch)
        res[arch + "|single|loss"] = np.float32(m["loss"])
        res[arch + "|single|grad_norm"] = np.float32(m["grad_norm"])
        for k, v in flat(p).items():
            res[arch + "|single|" + k] = v.float().numpy()
    np.savez(DIR + "/out_port.npz", **res)
"""


def _run(script, path, env):
    """The script from a file: the port's ranks are spawned, and a spawned
    child imports its parent's main module by path."""
    path.write_text(script)
    return subprocess.Popen([sys.executable, str(path)], cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_train")
    rng = np.random.default_rng(1)
    init = {}
    for arch in ARCHS:
        cfg = small(J_REGISTRY, j_reduced, arch)
        for k, v in _flat(j_init_params(jax.random.PRNGKey(0), cfg)).items():
            init[f"{arch}|{k}"] = v
        init[f"{arch}|tokens"] = rng.integers(0, cfg.vocab, (8, 64),
                                              dtype=np.int32)
    np.savez(tmp / "init.npz", **init)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    fill = {"archs": ARCHS, "dir": str(tmp), "grad_impl": GRAD_ORACLE_IMPL}
    procs = {"jax": _run(JAX_SCRIPT % fill, tmp / "jax_side.py", env),
             "port": _run(PORT_SCRIPT % fill, tmp / "port_side.py", env)}
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name}: {err[-4000:]}"
    return {name: dict(np.load(tmp / f"out_{name}.npz")) for name in procs}


def _leaves(out, arch, tag=""):
    head = f"{arch}|{tag}"
    return {k[len(head):]: v for k, v in out.items()
            if k.startswith(head + "/")}


def _grad_errs(got, want):
    """Each leaf's gradient error relative to the reference's gradient,
    ||got - want|| / ||want|| (Frobenius), leaf by leaf."""
    assert set(got) == set(want)
    return {k: float(np.linalg.norm(got[k] - want[k])
                     / max(float(np.linalg.norm(want[k])), 1e-30))
            for k in want}


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_gradients_match_jax_sharded(runs, arch):
    """Every leaf's gradient (fp32 compute) against the reference's
    sharded gradient, within ``GRAD_TOL`` relative."""
    errs = _grad_errs(_leaves(runs["port"], arch, "grad|"),
                      _leaves(runs["jax"], arch, "grad|"))
    worst = max(errs, key=errs.get)
    print(json.dumps({"arch": arch, "worst_leaf": worst,
                      "grad_rel_err": errs[worst], "all": errs}))
    assert errs[worst] < GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("arch", DENSE)
def test_sharded_gradients_match_single_device_port(runs, arch):
    """The dense archs' sharded gradients against the port's
    single-device ones, leaf by leaf, within ``GRAD_TOL`` relative."""
    errs = _grad_errs(_leaves(runs["port"], arch, "grad|"),
                      _leaves(runs["port"], arch, "single|grad|"))
    worst = max(errs, key=errs.get)
    print(json.dumps({"arch": arch, "worst_leaf": worst,
                      "grad_rel_err": errs[worst], "all": errs}))
    assert errs[worst] < GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_matches_jax_sharded(runs, arch):
    """Loss within 5e-3 and parameters within 5e-2 of the reference's
    sharded step (its own bounds); the MoE archs included, since both
    sides route each (data, model) shard's tokens with its own capacity."""
    j, t = runs["jax"], runs["port"]
    dl = abs(float(j[f"{arch}|loss"]) - float(t[f"{arch}|loss"]))
    dn = abs(float(t[f"{arch}|grad_norm"]) / float(j[f"{arch}|grad_norm"]) - 1)
    jl, tl = _leaves(j, arch), _leaves(t, arch)
    assert set(jl) == set(tl)
    err = max(float(np.max(np.abs(jl[k] - tl[k]))) for k in jl)
    print(json.dumps({"arch": arch, "loss_diff": dl, "param_err": err,
                      "grad_norm_rel": dn}))
    assert dl < 5e-3, dl
    assert err < 5e-2, err
    assert dn < 2e-2, dn


@pytest.mark.parametrize("arch", DENSE)
def test_sharded_train_step_matches_single_device_port(runs, arch):
    """The dense archs' sharded step against the port's own single-device
    step, to the same bounds."""
    t = runs["port"]
    dl = abs(float(t[f"{arch}|loss"]) - float(t[f"{arch}|single|loss"]))
    dn = abs(float(t[f"{arch}|grad_norm"])
             / float(t[f"{arch}|single|grad_norm"]) - 1)
    sh, one = _leaves(t, arch), _leaves(t, arch, "single|")
    assert set(sh) == set(one)
    err = max(float(np.max(np.abs(sh[k] - one[k]))) for k in sh)
    print(json.dumps({"arch": arch, "loss_diff": dl, "param_err": err,
                      "grad_norm_rel": dn}))
    assert dl < 5e-3, dl
    assert err < 5e-2, err
    assert dn < 2e-2, dn
