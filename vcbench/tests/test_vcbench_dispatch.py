"""A configuration reaches the harness through the reference module that it
names: a tiny configuration whose ``reference`` is a module of the test
data (the dense one, its calls recorded) gets its weights, its check and
its counts from that module, in a serving and a training run on the CPU,
with no harness file edited. A configuration that its module does not
cover stops at set-up, with an error that names it and its
``reference``."""
import dataclasses
import time
from pathlib import Path

import pytest
import torch

from harness import cell as cell_mod
from harness import flops, serve
from harness.manifest import load_cell, reference

DATA = Path(__file__).resolve().parent / "data"
CPU = torch.device("cpu")
SEED = 2 ** 31 + 977


def tiny(name):
    return load_cell(name, DATA / "BENCHMARK.json", DATA)


@pytest.fixture
def calls(monkeypatch):
    monkeypatch.setattr(serve, "WAIT_S", 5)
    mod = reference(tiny("tiny-recorded.chat_tiny"))
    mod.CALLS.clear()
    return mod.CALLS


def test_the_loader_takes_the_named_module():
    mod = reference(tiny("tiny-recorded.chat_tiny"))
    assert Path(mod.__file__) == DATA / "recording_reference.py"
    assert reference(tiny("tiny-recorded.train_tiny")) is mod
    dense = reference(tiny("tiny-dense.chat_tiny"))
    assert Path(dense.__file__).parts[-2:] == ("reference", "model.py")
    assert dense is not mod


def test_a_serving_run_takes_all_from_the_named_module(calls):
    out = cell_mod.run_cell(tiny("tiny-recorded.chat_tiny"), SEED, 1.5,
                            True, CPU, time.monotonic(), log=lambda m: None)
    assert out["correct"], out["checks"]
    # the weights, the admission rule, the check, the counts
    assert {"leaves", "exact_admission", "Ref.hidden", "prefill_flops",
            "decode_flops"} <= set(calls), calls
    assert {"prefill_mfu", "decode_mfu"} <= set(out["metrics"])


def test_a_training_run_takes_all_from_the_named_module(calls):
    out = cell_mod.run_cell(tiny("tiny-recorded.train_tiny"), SEED, 1.5,
                            True, CPU, time.monotonic(), log=lambda m: None)
    assert out["correct"], out["checks"]
    # the weights (and their change, made again), the inputs, the
    # reference's steps, the count of a step
    assert {"leaves", "inputs", "Ref.row_loss_sum",
            "model_flops_for"} <= set(calls), calls
    assert "train_mfu" in out["metrics"]


def test_the_kernel_bounds_come_from_the_named_module(calls):
    c = tiny("tiny-recorded.chat_tiny")
    f, m = flops.counts(c.config), c.config["model"]
    dense = reference(tiny("tiny-dense.chat_tiny"))
    assert f.attention_bound_s(m, [5, 9]) == dense.attention_bound_s(
        m, [5, 9], bound=flops._bound)
    assert f.decode_attention_bound_s(m, 2, 30) == \
        dense.decode_attention_bound_s(m, 2, 30, bound=flops._bound)
    assert calls == ["unsupported", "attention_bound_s",
                     "decode_attention_bound_s"]


@pytest.mark.parametrize("change,lacks", [
    ({"layer_pattern": "gm"}, "layer_pattern"),
    ({"n_experts": 4, "experts_per_tok": 2}, "n_experts")])
@pytest.mark.parametrize("name", ["tiny-dense.chat_tiny",
                                  "tiny-vlm.train_tiny"])
def test_an_uncovered_architecture_stops_at_set_up(name, change, lacks):
    c = tiny(name)
    config = dict(c.config, name="tiny-hybrid",
                  model=dict(c.config["model"], **change))
    c = dataclasses.replace(c, config=config)
    with pytest.raises(NotImplementedError) as err:
        cell_mod.run_cell(c, SEED, 1.0, False, CPU, time.monotonic(),
                          log=lambda m: None)
    msg = str(err.value)
    assert "'tiny-hybrid'" in msg and '"reference"' in msg, msg
    assert "vcbench/reference/model.py" in msg and lacks in msg, msg


@pytest.mark.parametrize("path", ["/etc/passwd", "../outside.py",
                                  "vcbench/reference/absent.py"])
def test_a_reference_outside_the_checkout_is_refused(path):
    config = dict(tiny("tiny-dense.chat_tiny").config, reference=path)
    with pytest.raises(ValueError, match="no file of the checkout"):
        reference(config)
