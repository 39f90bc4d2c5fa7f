"""The port's sharded prefill and decode on 8 CPU ranks against the JAX
package's, on a (2, 4) ("data", "model") mesh (the JAX side in one
subprocess with 8 host devices and ``AxisType.Auto`` axes, the port's on 8
gloo ranks in another; the two run at once).

Cases, each on the reference's initial parameters of a reduced config,
numpy-seeded ragged prompts (B 4, S 32, lengths 32/5/17/28) and a cache of
64 positions, fp32 compute:

- "tp_heads": qwen2-7b's prefill plan: heads sharded over "model", the kv
  heads (2 of them) replicated, the residual stream sequence-sharded, the
  cache sequence-sharded (each rank writes its slice);
- "context": the same with 6 heads on "model" 4: each rank's q rows at
  their global offset against all-gathered K/V;
- "decode", "decode_bf16", "window": decode plans (cache sequence-sharded
  over "model", weights row-parallel) for a prefill and 3 decode steps,
  the partials of each slice combined across ranks; rows of length 5 hold
  no valid position on three of the four slices; gemma2-9b with window 24
  (its softcaps) spans slices;
- "rwkv6": the prefill plan (4 heads on "model": the scan on each rank's
  heads), then 3 decode steps under the decode plan;
- "jamba": the prefill plan (Mamba "inner" sharded, attention, and MoE
  with the experts sharded and each (data, model) shard's own capacity);
- "olmoe": a decode plan (MoE tokens sharded by batch only).

Tolerances: the port's parity tolerances (``tests/test_torch_models.py``):
1e-4 with an fp32 cache, 1e-2 with a bf16 cache ("decode_bf16"). Readings
on the CPU: <= 7.7e-6 for every case and step, "decode_bf16" 1.6e-6 (the
MoE cases too: both sides route each shard's tokens with its capacity).
"""
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
B, S, L, STEPS = 4, 32, 64, 3
LENGTHS = [32, 5, 17, 28]
# name: (arch, config overrides, plan of the prefill, decode steps, cache)
CASES = {
    "tp_heads": ("qwen2-7b", {}, "prefill", 0, "float32"),
    "context": ("qwen2-7b", {"n_heads": 6, "n_kv_heads": 2}, "prefill", 0,
                "float32"),
    "decode": ("qwen2-7b", {}, "decode", STEPS, "float32"),
    "decode_bf16": ("qwen2-7b", {}, "decode", STEPS, "bfloat16"),
    "window": ("gemma2-9b", {"sliding_window": 24}, "decode", STEPS,
               "float32"),
    "rwkv6": ("rwkv6-7b", {}, "prefill", STEPS, "float32"),
    "jamba": ("jamba-v0.1-52b", {}, "prefill", 0, "float32"),
    "olmoe": ("olmoe-1b-7b", {}, "decode", STEPS, "float32"),
}
TOL = {"float32": 1e-4, "bfloat16": 1e-2}


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree, np.float32)}


COMMON = r"""
import numpy as np
CASES = %(cases)r
DIR = %(dir)r
B, S, L, STEPS = %(shape)r
init = dict(np.load(DIR + "/init.npz"))


def tree(name):
    out = {}
    for key, val in init.items():
        n, path = key.split("|", 1)
        if n != name or not path.startswith("/"):
            continue
        node = out
        parts = path.strip("/").split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def config(registry, reduce, name):
    arch, over = CASES[name][:2]
    return reduce(registry[arch], **over)


def shape(ShapeConfig, name, kind):
    return ShapeConfig(kind, S if kind == "prefill" else L, B, kind)
"""

JAX_SCRIPT = COMMON + r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import REGISTRY, reduced
from repro.models import decode_step, init_cache, prefill
from repro.models.config import ShapeConfig
from repro.sharding.api import use_rules
from repro.sharding.planner import plan_for, serve_shardings

mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
res = {}
for name, (arch, over, kind, steps, cdt) in CASES.items():
    cfg = config(REGISTRY, reduced, name)
    params = jax.tree.map(jnp.asarray, tree(name))
    cache = init_cache(cfg, B, L, dtype=getattr(jnp, cdt))
    toks, lens = jnp.asarray(init[name + "|tokens"]), jnp.asarray(init[name + "|lengths"])
    f32 = jnp.float32
    for i, k in enumerate([kind] + ["decode"] * steps):
        plan = plan_for(cfg, shape(ShapeConfig, name, k), mesh)
        sh = serve_shardings(plan, cfg)
        tok = toks if i == 0 else jnp.asarray(init[name + "|next"][i - 1])
        args = jax.device_put((params, tok, cache, lens),
                              (sh["params"], sh["tokens"], sh["cache"],
                               sh["lengths"]))
        with use_rules(plan.rules), mesh:
            if i == 0:
                fn = jax.jit(lambda p, t, c, l: prefill(
                    p, cfg, t, c, lengths=l, compute_dtype=f32))
                logits, cache, lens = fn(*args)
                lens = lens + 1
            else:
                fn = jax.jit(lambda p, t, c, l: decode_step(
                    p, cfg, t, c, l, compute_dtype=f32))
                logits, cache, lens = fn(*args)
        res[name + "|" + str(i)] = np.asarray(logits, np.float32)
np.savez(DIR + "/out_jax.npz", **res)
"""

PORT_SCRIPT = COMMON + r"""
import torch
from repro_torch.launch.spmd import spawn


def rank(r, n):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import REGISTRY, reduced
    from repro_torch.models import (cache_axes, decode_step, init_cache,
                                    param_axes, prefill)
    from repro_torch.models.config import ShapeConfig
    from repro_torch.models.convert import params_from_jax
    from repro_torch.sharding.api import use_rules
    from repro_torch.sharding.planner import plan_for

    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    res = {}
    f32 = torch.float32
    for name, (arch, over, kind, steps, cdt) in CASES.items():
        cfg = config(REGISTRY, reduced, name)
        params = params_from_jax(tree(name), cfg, device="cpu",
                                 compute_dtype=f32)
        cache = init_cache(cfg, B, L, dtype=getattr(torch, cdt), device="cpu")
        toks = torch.from_numpy(init[name + "|tokens"])
        lens = torch.from_numpy(init[name + "|lengths"])
        for i, k in enumerate([kind] + ["decode"] * steps):
            plan = plan_for(cfg, shape(ShapeConfig, name, k), mesh)
            p = plan.distribute(params, param_axes(cfg))
            cache = plan.distribute(cache, cache_axes(cfg))
            with use_rules(plan.rules), implicit_replication():
                if i == 0:
                    logits, cache, lens = prefill(p, cfg, toks, cache,
                                                  lengths=lens,
                                                  compute_dtype=f32)
                    lens = lens + 1
                else:
                    nxt = torch.from_numpy(init[name + "|next"][i - 1])
                    logits, cache, lens = decode_step(p, cfg, nxt, cache,
                                                      lens, compute_dtype=f32)
            res[name + "|" + str(i)] = logits.full_tensor().numpy()
    return res if r == 0 else None


if __name__ == "__main__":
    np.savez(DIR + "/out_port.npz", **spawn(rank, 8)[0])
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_serve")
    rng = np.random.default_rng(2)
    init = {}
    for name, (arch, over) in ((n, c[:2]) for n, c in CASES.items()):
        cfg = j_reduced(J_REGISTRY[arch], **over)
        for k, v in _flat(j_init_params(jax.random.PRNGKey(0), cfg)).items():
            init[f"{name}|{k}"] = v
        init[f"{name}|tokens"] = rng.integers(0, cfg.vocab, (B, S),
                                              dtype=np.int32)
        init[f"{name}|lengths"] = np.array(LENGTHS, np.int32)
        init[f"{name}|next"] = rng.integers(0, cfg.vocab, (STEPS, B, 1),
                                            dtype=np.int32)
    np.savez(tmp / "init.npz", **init)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    env.pop("XLA_FLAGS", None)
    fill = {"cases": CASES, "dir": str(tmp), "shape": (B, S, L, STEPS)}
    procs = {}
    for name, script in (("jax", JAX_SCRIPT), ("port", PORT_SCRIPT)):
        path = tmp / f"{name}_side.py"      # the port's spawned ranks
        path.write_text(script % fill)      # import their main by path
        procs[name] = subprocess.Popen(
            [sys.executable, str(path)], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for name, proc in procs.items():
        _, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, f"{name}: {err[-4000:]}"
    return {name: dict(np.load(tmp / f"out_{name}.npz")) for name in procs}


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_logits_match_jax_sharded(runs, name):
    """Every step's logits (the prefill's last positions, then each decode
    step's) of the port's sharded run against the reference's."""
    steps, cdt = CASES[name][3], CASES[name][4]
    for i in range(steps + 1):
        j, t = runs["jax"][f"{name}|{i}"], runs["port"][f"{name}|{i}"]
        assert t.shape == j.shape
        err = float(np.max(np.abs(t - j)))
        print(f"{name} step {i}: max abs err {err:.3g}")
        np.testing.assert_allclose(t, j, atol=TOL[cdt], rtol=TOL[cdt],
                                   err_msg=f"{name} step {i}")
