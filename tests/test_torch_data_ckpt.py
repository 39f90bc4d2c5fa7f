"""Data pipeline and checkpoints of the PyTorch port against the JAX
package, and the port's training entry points on the CPU.

``SyntheticTokens`` and packing are copies and must give the reference's
arrays exactly. A checkpoint written by either package restores in the
other, the same flat keys and the values bit for bit. The launcher and the
tenant example run a few steps on the CPU (``--device cpu``).
"""
import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")   # the reference; absent on the card's machine
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.ckpt import CheckpointManager as JCheckpointManager
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticTokens as JSyntheticTokens
from repro.data import pack_documents as j_pack
from repro.models import init_params as j_init_params
from repro.models.config import ShapeConfig as JShapeConfig
from repro.training import make_opt_state as j_make_opt_state
from repro_torch import configs as tconfigs
from repro_torch.ckpt import CheckpointManager
from repro_torch.data import DataConfig, Prefetcher, SyntheticTokens
from repro_torch.data import pack_documents
from repro_torch.models import convert
from repro_torch.models.config import ShapeConfig
from repro_torch.training import make_opt_state
from repro_torch.training.optimizer import tree_map

REPO = Path(__file__).resolve().parents[1]


# ------------------------------------------------------------------ data

@pytest.mark.parametrize("arch", ["qwen2-7b", "internvl2-2b",
                                  "seamless-m4t-large-v2"])
@pytest.mark.parametrize("shard", [(0, 1), (1, 2)])
def test_synthetic_tokens_equal_the_reference(arch, shard):
    """Tokens, mask and the frontends' patches and frames, array for
    array, at two steps."""
    jcfg = jconfigs.reduced(jconfigs.get_config(arch))
    tcfg = tconfigs.reduced(tconfigs.get_config(arch))
    jd = JSyntheticTokens(jcfg, JShapeConfig("t", 16, 8, "train"),
                          JDataConfig(seed=3), *shard)
    td = SyntheticTokens(tcfg, ShapeConfig("t", 16, 8, "train"),
                         DataConfig(seed=3), *shard)
    for step in (0, 7):
        a, b = jd.batch_at(step), td.batch_at(step)
        assert set(a) == set(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    assert b["tokens"].dtype == np.int32


@pytest.mark.parametrize("seed", range(5))
def test_packing_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    docs = [rng.integers(1, 1000, size=n).astype(np.int32)
            for n in rng.integers(1, 30, size=rng.integers(1, 20))]
    seq_len = int(rng.integers(8, 64))
    a, b = j_pack(docs, seq_len, pad_id=0), pack_documents(docs, seq_len)
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_prefetcher_preserves_order():
    pf = Prefetcher(iter([{"i": i} for i in range(5)]), depth=2)
    assert [b["i"] for b in pf] == list(range(5))


# ------------------------------------------------------------ checkpoints

def _states():
    """(JAX, port) training states (params, opt) of reduced qwen2-7b, the
    same values, after the moments were filled with numbers."""
    jcfg = jconfigs.reduced(jconfigs.get_config("qwen2-7b"))
    tcfg = tconfigs.reduced(tconfigs.get_config("qwen2-7b"))
    jp = j_init_params(jax.random.PRNGKey(0), jcfg)
    jo = j_make_opt_state(jp)
    rng = np.random.default_rng(0)
    jo = {"step": jnp.int32(7),
          "m": jax.tree.map(lambda x: jnp.asarray(rng.standard_normal(
              x.shape).astype(np.float32)), jo["m"]),
          "v": jax.tree.map(lambda x: jnp.asarray(rng.random(
              x.shape).astype(np.float32)), jo["v"])}
    np_tree = jax.tree.map(lambda x: np.asarray(x, np.float32), jp)
    tp = convert.params_from_jax(np_tree, tcfg, device="cpu",
                                 compute_dtype=torch.float32)
    to = make_opt_state(tp)
    to["step"] = torch.tensor(7, dtype=torch.int32)
    to["m"] = tree_map(torch.from_numpy,
                       jax.tree.map(lambda x: np.array(x), jo["m"]))
    to["v"] = tree_map(torch.from_numpy,
                       jax.tree.map(lambda x: np.array(x), jo["v"]))
    return (jp, jo), (tp, to)


def _flat(tree, prefix=""):
    if isinstance(tree, (dict, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def _manifest_keys(directory, step):
    import json
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)["keys"]


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    jstate, tstate = _states()
    CheckpointManager(str(tmp_path), async_write=False).save(
        3, tstate, block=True)
    keys = _manifest_keys(tmp_path, 3)
    assert "0/blocks/sub0/attn/wq/w" in keys and "1/step" in keys
    like = jax.tree.map(jnp.zeros_like, jstate)
    restored, step = JCheckpointManager(str(tmp_path)).restore(like)
    assert step == 3
    fr, fj = _flat(restored), _flat(jstate)
    assert set(fr) == set(fj) == set(keys)
    for k in fj:
        assert fr[k].dtype == fj[k].dtype, k
        np.testing.assert_array_equal(np.asarray(fr[k]), np.asarray(fj[k]))


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    jstate, tstate = _states()
    JCheckpointManager(str(tmp_path), async_write=False).save(
        5, jstate, block=True)
    like = tuple(tree_map(torch.zeros_like, t) for t in tstate)
    restored, step = CheckpointManager(str(tmp_path)).restore(like)
    assert step == 5
    fr, ft = _flat(restored), _flat(tstate)
    assert set(fr) == set(ft) == set(_manifest_keys(tmp_path, 5))
    for k in ft:
        assert fr[k].dtype == ft[k].dtype and fr[k].device == ft[k].device, k
        assert torch.equal(fr[k], ft[k]), k
    # fresh tensors, not the ones given as the template
    assert fr["0/embed/table"].data_ptr() != like[0]["embed"]["table"].data_ptr()


def test_bf16_leaf_is_refused(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    with pytest.raises(TypeError, match="bfloat16"):
        mgr.save(1, {"w": torch.zeros(2, dtype=torch.bfloat16)})
    assert mgr.all_steps() == []


def test_restore_checks_shapes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, {"w": torch.zeros(3)}, block=True)
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.zeros(4)})
    with pytest.raises(KeyError, match="missing key x"):
        mgr.restore({"x": torch.zeros(3)})


def test_checkpoint_roundtrip_and_gc(tmp_path):
    """Twin of ``tests/test_training_data_ckpt.py``'s: GC keeps the last 2;
    restore gives the saved values in the template's dtypes."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = {"a": torch.arange(6).reshape(2, 3), "b": {"c": torch.ones(4)}}
    for s in (1, 5, 9):
        mgr.save(s, tree, block=True)
    assert mgr.all_steps() == [5, 9]
    restored, step = mgr.restore(tree_map(torch.zeros_like, tree))
    assert step == 9
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["b"]["c"], tree["b"]["c"])


def test_checkpoint_crash_safety(tmp_path):
    """A directory without manifest.json (mid-write crash) is invisible."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(3, {"x": torch.ones(2)}, block=True)
    os.makedirs(tmp_path / "step_00000007")   # corrupt: no manifest
    assert mgr.all_steps() == [3]
    assert mgr.latest_step() == 3
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore({})


def test_checkpoint_async_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    x = torch.arange(3)
    mgr.save(1, {"x": x})
    x.add_(10)             # the snapshot was taken at save time
    mgr.wait()
    assert mgr.all_steps() == [1]
    restored, _ = mgr.restore({"x": torch.zeros(3, dtype=torch.int64)})
    assert torch.equal(restored["x"], torch.arange(3))


# ------------------------------------------------------------ entry points

def test_launch_train_runs_saves_and_resumes(tmp_path, capsys):
    """``launch/train.py --device cpu``: 3 steps with a checkpoint each,
    then ``--resume`` to 5 steps from the last one."""
    from repro_torch.launch.train import main
    base = ["--arch", "qwen2-7b", "--reduced", "--batch", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "1",
            "--log-every", "1", "--device", "cpu"]
    assert main(base + ["--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "arch=qwen2-7b-reduced" in out and "tokens/step=32" in out
    assert [ln.split()[1] for ln in out.splitlines()
            if ln.startswith("step")] == ["1", "2", "3"]
    assert CheckpointManager(str(tmp_path)).all_steps() == [1, 2, 3]
    assert main(base + ["--steps", "5", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 3" in out
    assert [ln.split()[1] for ln in out.splitlines()
            if ln.startswith("step")] == ["4", "5"]
    for ln in out.splitlines():
        if ln.startswith("step"):
            assert np.isfinite(float(ln.split("loss=")[1].split()[0]))
    assert CheckpointManager(str(tmp_path)).all_steps() == [3, 4, 5]


@pytest.mark.parametrize("arch", ["rwkv6-7b", "jamba-v0.1-52b"])
def test_launch_train_trains_recurrent_archs(tmp_path, capsys, arch):
    """``--arch rwkv6-7b`` and ``--arch jamba-v0.1-52b`` with ``--reduced``
    train on the CPU (through the scans' training form): 2 steps, finite
    losses."""
    from repro_torch.launch.train import main
    assert main(["--arch", arch, "--reduced", "--batch", "2", "--seq", "16",
                 "--steps", "2", "--log-every", "1", "--device", "cpu"]) == 0
    steps = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step")]
    assert [ln.split()[1] for ln in steps] == ["1", "2"]
    assert all(np.isfinite(float(ln.split("loss=")[1].split()[0]))
               for ln in steps)


def _example():
    path = REPO / "examples" / "train_tenant_job_torch.py"
    spec = importlib.util.spec_from_file_location("train_tenant_job_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_train_tenant_job_example_finishes_its_units(tmp_path):
    """The example's units run as WorkUnits of a live framework on the
    CPU: every unit reaches Ready, each saves a checkpoint (the last 2
    kept), and the last restores to the live state bit for bit."""
    out = _example().run("tiny", units=3, steps_per_unit=3,
                         ckpt_dir=str(tmp_path), device="cpu",
                         log=lambda m: None)
    assert [u["phase"] for u in out["units"]] == ["Ready"] * 3
    losses = out["state"]["losses"]
    assert len(losses) == 9 and all(np.isfinite(losses))
    mgr = out["mgr"]
    assert mgr.all_steps() == [6, 9]
    live = (out["state"]["params"], out["state"]["opt"])
    restored, step = mgr.restore(tuple(tree_map(torch.zeros_like, t)
                                       for t in live))
    assert step == 9
    fr, fl = _flat(restored), _flat(live)
    assert set(fr) == set(fl)
    for k in fl:
        assert torch.equal(fr[k], fl[k]), k
