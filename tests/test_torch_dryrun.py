"""The port's dry-run (``repro_torch.launch.dryrun``) against the JAX
package's, on the CPU.

Seven archs (qwen2-7b, gemma2-9b, olmoe-1b-7b, rwkv6-7b, jamba-v0.1-52b,
seamless-m4t-large-v2, internvl2-2b) at train, prefill and decode on a
(2, 4) ("data", "model") mesh, each side in its own subprocess, the two
started together. The reference lowers and compiles its step
(``repro.launch.dryrun._lower_*``) on 8 host devices with ``AxisType.Auto``
axes (JAX 0.9's default ``Explicit`` axes are refused by its
``with_sharding_constraint``, ``ROADMAP.md`` section 3) and counts it with
``repro.roofline.hlo_cost.analyze``; the port traces its step on fake
tensors over a fake group of 8 (``lower_cell``). Per device, the port's
FLOPs must lie within 5% of the reference's.

The cells run at each config's own widths, cut in depth to one block
period (one layer; gemma2-9b's "lg" two, jamba's period of eight;
seamless one encoder and one decoder layer), train and prefill at B 8,
S 512, decode at decode_32k's batch of 128 against a cache of 512
(internvl2-2b needs S past its 256 patches). At ``reduced()``'s widths
(d 64) the count measures the CPU compile, not the step: XLA's CPU backend
runs bf16 products in fp32 and converts each bf16 operand, and its
``convert`` ops count one FLOP an element (9-47% of the reference's
FLOPs there, once per weight a call: at a decode batch of 8 still 18%
at full width), and XLA's CSE merges the attention backward's
recomputed products, which the port runs eagerly. Readings at these
sizes: -3.24% (seamless decode) to +0.35% (products alone: equal in
most, +1.1% at most).

One reference-side adjustment, the same rule for every cell: jamba's
compiled train step recomputes the MoE experts' products once more than
the port and than the reference's own olmoe-1b-7b step (XLA keeps the
block's outer remat of its nested ``jax.checkpoint`` in 3 of jamba's 4
MoE layers: 270 GFLOP a device, 10% of its products). Those products
(``dot`` ops whose ``op_name`` holds the outer ``rematted_computation``
but not the nested ``checkpoint/checkpoint``, on the expert einsums) are
taken off the reference's count; without it jamba train reads -10.8%.

Bytes and collectives are printed side by side and not held: the
reference counts the bytes at the fusion boundaries of XLA's CPU compile
(which also converts every bf16 weight to fp32 and back), the port every
op's operands and results as its eager and graphed runs launch them
(0.26-1.29x the reference's here), and each side lays out its own
collectives (XLA's partitioner against the port's explicit bodies and
DTensor's redistributions).

The port's repairs for fake tensors (``sharding/collectives.py``:
``local_shape``/``global_offset`` under a fake mode, ``all_reduce``
through ``wait_tensor``) each have a test here, and one full-size cell:
qwen2-7b train_4k on the 16 x 16 production mesh, in under 60 s of the
process's CPU time (22-27 s alone on 8 cores; its wall time under the
suite's other workers read 64 s).
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

jax = pytest.importorskip("jax")   # the reference; absent on the card's machine

REPO = Path(__file__).resolve().parents[1]
ARCHS = ["qwen2-7b", "gemma2-9b", "olmoe-1b-7b", "rwkv6-7b",
         "jamba-v0.1-52b", "seamless-m4t-large-v2", "internvl2-2b"]
KINDS = ["train", "prefill", "decode"]
FLOPS_TOL = 0.05

COMMON = r"""
import dataclasses, json, sys
ARCHS = %(archs)r
KINDS = %(kinds)r


def cut(base):
    over = dict(n_layers=len(base.layer_pattern))
    if base.n_enc_layers:
        over["n_enc_layers"] = 1
    return dataclasses.replace(base, **over)


def shape_of(ShapeConfig, kind):
    return ShapeConfig(kind, 512, 128 if kind == "decode" else 8, kind)
"""

JAX_SCRIPT = COMMON + r"""
import os, re
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
os.environ["_DRYRUN_NO_FLAGS"] = "1"
import jax
from jax.sharding import AxisType
from repro.configs import get_config
from repro.launch import dryrun as D
from repro.models.config import ShapeConfig
from repro.roofline import hlo_cost
from repro.sharding.api import use_rules
from repro.sharding.planner import plan_for

OP_NAME = re.compile(r'op_name="([^"]*)"')


def second_moe_remat(hlo):
    # dot FLOPs of the expert einsums in the block's outer remat of the
    # nested checkpoint (see the test's docstring), trip counts included
    m = hlo_cost.HloCostModel(hlo)
    total = 0.0

    def walk(comp, mult):
        nonlocal total
        syms = m._symbols(comp)
        for op in m.computations.get(comp, []):
            if op.opcode == "dot":
                nm = OP_NAME.search(op.line)
                nm = nm.group(1) if nm else ""
                if ("rematted_computation" in nm
                        and "checkpoint/checkpoint" not in nm
                        and ("ecd,edf" in nm or "ecf,efd" in nm)):
                    total += m._dot_flops(op, syms) * mult
            elif op.opcode == "while":
                body = hlo_cost._BODY.search(op.line)
                cond = hlo_cost._COND.search(op.line)
                trips = m._trip_count(cond.group(1))
                walk(body.group(1), mult * trips)
                walk(cond.group(1), mult * trips)
            elif op.opcode in ("call", "fusion", "conditional", "async-start"):
                for sub in hlo_cost._CALLS.finditer(op.line):
                    walk(sub.group(1), mult)

    walk(m.entry, 1.0)
    return total


mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
lower = {"train": D._lower_train, "prefill": D._lower_prefill,
         "decode": D._lower_decode}
res = {}
for arch in ARCHS:
    for kind in KINDS:
        cfg = cut(get_config(arch))
        shape = shape_of(ShapeConfig, kind)
        plan = plan_for(cfg, shape, mesh)
        with use_rules(plan.rules):
            hlo = lower[kind](cfg, shape, mesh, plan).compile().as_text()
        c = hlo_cost.analyze(hlo)
        res[arch + "|" + kind] = {
            "flops": c.flops, "second_moe_remat": second_moe_remat(hlo),
            "bytes": c.bytes, "collectives": c.coll_counts}
json.dump(res, open(sys.argv[1], "w"))
"""

PORT_SCRIPT = COMMON + r"""
from repro_torch.configs import get_config
from repro_torch.launch.dryrun import lower_cell
from repro_torch.models.config import ShapeConfig
from repro_torch.sharding.api import abstract_mesh

res = {}
for arch in ARCHS:
    for kind in KINDS:
        base = get_config(arch)
        cfg = cut(base)
        rec = lower_cell(arch, kind, mesh=abstract_mesh((2, 4),
                                                        ("data", "model")),
                         cut={f.name: getattr(cfg, f.name)
                              for f in dataclasses.fields(cfg)
                              if getattr(cfg, f.name) != getattr(base, f.name)},
                         shape=shape_of(ShapeConfig, kind))
        res[arch + "|" + kind] = {
            "flops": rec["hlo_flops"] / rec["chips"],
            "matmul_flops": rec["matmul_flops"],
            "bytes": rec["hlo_bytes_raw"] / rec["chips"],
            "collectives": rec["collective_counts"],
            "status": rec["status"]}
json.dump(res, open(sys.argv[1], "w"))
"""


def _start(script, path, out, env):
    path.write_text(script)
    return subprocess.Popen([sys.executable, str(path), str(out)], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def counts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    fill = {"archs": ARCHS, "kinds": KINDS}
    procs = {side: _start(script % fill, tmp / f"{side}_side.py",
                          tmp / f"{side}.json", env)
             for side, script in (("jax", JAX_SCRIPT), ("port", PORT_SCRIPT))}
    out = {}
    for side, proc in procs.items():
        _, err = proc.communicate(timeout=900)
        assert proc.returncode == 0, f"{side} side failed:\n{err[-4000:]}"
        out[side] = json.loads((tmp / f"{side}.json").read_text())
    return out


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_traced_flops_match_reference(counts, arch, kind):
    key = f"{arch}|{kind}"
    ref, port = counts["jax"][key], counts["port"][key]
    assert port["status"] == "ok"
    want = ref["flops"] - ref["second_moe_remat"]
    err = port["flops"] / want - 1
    print(f"{key}: flops port {port['flops']:.6g} (products "
          f"{port['matmul_flops']:.6g}) vs reference {want:.6g} "
          f"({100 * err:+.2f}%); bytes port {port['bytes']:.6g} vs "
          f"{ref['bytes']:.6g}; collectives port {port['collectives']} vs "
          f"{ref['collectives']}")
    assert abs(err) <= FLOPS_TOL


def test_full_size_cell_on_the_production_mesh():
    import torch.distributed as dist
    from repro_torch.launch.dryrun import HBM_BUDGET, lower_cell
    # the dry-run's own time: CPU seconds of this process, which other
    # processes on the machine (the other test workers) do not stretch
    t0, c0 = time.monotonic(), time.process_time()
    rec = lower_cell("qwen2-7b", "train_4k")
    took = time.process_time() - c0
    print(f"qwen2-7b train_4k on 16 x 16: {took:.1f} s of CPU "
          f"({time.monotonic() - t0:.1f} s wall), microbatches "
          f"{rec['microbatches']}, peak {rec['bytes_per_device'] / 1e9:.3f} "
          f"GB, matmul {rec['matmul_flops']:.6g} FLOP a GPU")
    assert not dist.is_initialized()          # the fake group is gone
    assert rec["status"] == "ok" and rec["mesh"] == "16x16"
    assert rec["chips"] == 256 and rec["fits"]
    assert 0 < rec["bytes_per_device"] <= HBM_BUDGET
    assert rec["microbatches"] == 1           # fits at the first try
    assert rec["t_compute"] > 0 and rec["t_collective"] > 0
    assert set(rec["collective_bytes_by_link"]) == {"nic"}
    assert took < 60


def test_dryrun_refuses_a_process_group_that_is_up():
    import torch.distributed as dist
    from repro_torch.launch.dryrun import _fake_group, lower_cell
    _fake_group(8)
    try:
        with pytest.raises(RuntimeError, match="already up"):
            lower_cell("qwen2-7b", "train_4k")
        assert dist.get_world_size() == 8     # the caller's group is kept
    finally:
        dist.destroy_process_group()


def _on_fake_group(fn, rank=5):
    """``fn(mesh)`` as rank ``rank`` of a fake group of 8, on a (2, 4)
    mesh (rank 5 sits at (1, 1))."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=8)
    try:
        return fn(init_device_mesh("cpu", (2, 4),
                                   mesh_dim_names=("data", "model")))
    finally:
        dist.destroy_process_group()


def test_shard_box_under_fake_tensors():
    """``local_shape`` and ``global_offset`` read the mesh's coordinates
    with the fake mode set aside, and give the real tensors' tuples."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Shard, distribute_tensor
    from repro_torch.sharding import collectives as col

    def run(mesh):
        pl = (Shard(0), Shard(2))
        real = distribute_tensor(torch.zeros(6, 5, 12), mesh, pl)
        want = (col.local_shape(real), col.global_offset(real),
                col.global_offset(real, (Shard(1), Shard(0))))
        with FakeTensorMode(allow_non_fake_inputs=True):
            fake = distribute_tensor(torch.zeros(6, 5, 12), mesh, pl)
            got = (col.local_shape(fake), col.global_offset(fake),
                   col.global_offset(fake, (Shard(1), Shard(0))))
        return want, got

    want, got = _on_fake_group(run)
    assert got == want == ((3, 5, 3), (3, 0, 3), (2, 3, 0))


def test_all_reduce_waits_on_fake_tensors():
    from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode
    from repro_torch.sharding import collectives as col

    def run(mesh):
        with FakeTensorMode():
            out = col.all_reduce(torch.empty(4, 3), "max", mesh, "model")
        return out

    out = _on_fake_group(run)
    assert isinstance(out, FakeTensor) and tuple(out.shape) == (4, 3)


@pytest.mark.parametrize("kind", ["train", "decode"])
def test_reduced_sharded_steps_run_on_fake_tensors(kind):
    """The reduced sharded train and decode steps run under
    ``FakeTensorMode`` on a fake group: each reaches ``global_offset``
    (the embedding, attention and the cache write) and ``all_reduce``
    (the loss's and decode attention's combines)."""
    import torch.distributed as dist
    from repro_torch.configs import reduced
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding.api import abstract_mesh
    cfg = reduced(get_config("qwen2-7b"))
    rec = lower_cell("qwen2-7b", kind,
                     mesh=abstract_mesh((2, 4), ("data", "model")),
                     cut=dict(n_layers=cfg.n_layers, d_model=64, n_heads=4,
                              n_kv_heads=4, head_dim=16, d_ff=128, vocab=256),
                     shape=ShapeConfig(kind, 64, 8, kind))
    assert not dist.is_initialized()
    assert rec["status"] == "ok" and rec["chips"] == 8
    assert rec["collective_counts"].get("all-reduce", 0) > 0
    assert rec["matmul_flops"] > 0 and rec["bytes_per_device"] > 0


SHARDED_SCRIPT = r"""
import contextlib
import sys
import numpy as np
import torch
from repro_torch.launch.spmd import spawn


def steps(cfg, params, mesh, kinds, batch, sharded):
    # each step under its kind's plan on the mesh (or on one device); the
    # logits as numpy, the cache carried whole from step to step
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.models import (cache_axes, decode_step, init_cache,
                                    loss_fn, param_axes, prefill)
    from repro_torch.models.config import ShapeConfig
    from repro_torch.sharding.api import use_rules
    from repro_torch.sharding.planner import plan_for
    f32 = torch.float32

    def whole(t):
        return t.full_tensor() if hasattr(t, "full_tensor") else t

    out, lens, nxt = [], None, None
    cache = init_cache(cfg, 8, 32, enc_len=32 if cfg.is_encdec else 0,
                       dtype=f32, device="cpu")
    for kind in kinds:
        plan = plan_for(cfg, ShapeConfig(kind, 32, 8, kind), mesh)
        with contextlib.ExitStack() as stack:
            p, c = params, cache
            if sharded:
                p = plan.distribute(params, param_axes(cfg))
                c = plan.distribute(cache, cache_axes(cfg))
                stack.enter_context(use_rules(plan.rules))
                stack.enter_context(implicit_replication())
            if kind == "train":
                out.append(whole(loss_fn(p, batch, cfg, compute_dtype=f32)[0]))
                continue
            if kind == "prefill":
                logits, c, lens = prefill(p, cfg, batch["tokens"], c,
                                          compute_dtype=f32,
                                          **{k: v for k, v in batch.items()
                                             if k != "tokens"})
            else:
                logits, c, lens = decode_step(p, cfg, nxt, c, lens,
                                              compute_dtype=f32)
        logits, lens = whole(logits), whole(lens)
        cache = {k: {n: whole(t) for n, t in v.items()} for k, v in c.items()}
        nxt = logits[:, -1].argmax(-1, keepdim=True).int()
        out.append(logits)
    return [t.detach().float().numpy() for t in out]


def rank(r, n):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import init_params
    mesh = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    res = {}
    cases = {"patches": ("internvl2-2b", ["prefill", "train"], "patches"),
             "cross": ("seamless-m4t-large-v2",
                       ["prefill", "decode", "decode", "decode"], "frames")}
    for name, (arch, kinds, extra) in cases.items():
        cfg = reduced(get_config(arch))
        g = torch.Generator().manual_seed(0)
        params = init_params(cfg, generator=g, device="cpu",
                             dtype=torch.float32)
        rows = cfg.frontend_tokens if extra == "patches" else 32
        batch = {"tokens": torch.randint(0, cfg.vocab, (8, 32), generator=g),
                 extra: torch.randn(8, rows, cfg.frontend_dim, generator=g)}
        for sharded in (True, False):
            for i, t in enumerate(steps(cfg, params, mesh, kinds, batch,
                                        sharded)):
                res[f"{name}|{sharded}|{i}"] = t
    return res if r == 0 else None


if __name__ == "__main__":
    np.savez(sys.argv[1], **spawn(rank, 8)[0])
"""


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    """Two sharded paths that the dry-run's count found doing another
    rank's work, on 8 gloo ranks ((2, 4)) and on one device, fp32 compute,
    reduced configs."""
    import numpy as np
    tmp = tmp_path_factory.mktemp("sharded_paths")
    script, out = tmp / "sharded_side.py", tmp / "out.npz"
    script.write_text(SHARDED_SCRIPT)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.run([sys.executable, str(script), str(out)], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(out))


def _sharded_against_single(res, name):
    import numpy as np
    steps = sorted(int(k.split("|")[2]) for k in res
                   if k.startswith(f"{name}|True|"))
    return [float(np.abs(res[f"{name}|True|{i}"]
                         - res[f"{name}|False|{i}"]).max()) for i in steps]


def test_sharded_patches_match_single_device(sharded_runs):
    """The patches of a sharded step are projected on each rank's own
    rows and sequence shard (``transformer._rows_like``): reduced
    internvl2-2b's prefill logits and loss equal the single-device port's
    (1.4e-6 on the CPU)."""
    errs = _sharded_against_single(sharded_runs, "patches")
    print(f"patches: prefill logits, loss: {errs}")
    assert errs[0] <= 1e-4 and errs[1] <= 1e-5


def test_sharded_cross_decode_matches_single_device(sharded_runs):
    """A decode step's cross-attention against a sequence-sharded cross
    cache runs as decode attention at the cache's length on each rank's
    slice (``attention.attn_apply``), not on a gathered cache: reduced
    seamless-m4t-large-v2's prefill with 32 frames and 3 decode steps
    give the single-device port's logits (1.3e-6 on the CPU)."""
    errs = _sharded_against_single(sharded_runs, "cross")
    print(f"cross: prefill and decode logits: {errs}")
    assert max(errs) <= 1e-4
