"""A run of each kind of cell, on the CPU at a tiny size, with everything
but the look for a card: sound, it is ``correct``; with the timed path
broken underneath, or with the control (the reference in fp8) in the
program's place, it is not. The same control at each cell's own size
runs on the card (``cuda``)."""
import time
from pathlib import Path

import pytest
import torch

from harness import cell as cell_mod
from harness import check, serve
from harness.manifest import load_cell

DATA = Path(__file__).resolve().parent / "data"
CPU = torch.device("cpu")
SEED = 2 ** 31 + 977


def tiny(name):
    return load_cell(name, DATA / "BENCHMARK.json", DATA)


def run(name, seconds=1.5):
    return cell_mod.run_cell(tiny(name), SEED, seconds, False, CPU,
                             time.monotonic(), log=lambda m: None)


@pytest.fixture(autouse=True)
def short_wait(monkeypatch):
    monkeypatch.setattr(serve, "WAIT_S", 5)


@pytest.mark.parametrize("name", ["tiny-dense.chat_tiny",
                                  "tiny-vlm.train_tiny"])
def test_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out) >= {"correct", "attempted", "failed", "metrics",
                        "device"}


def _alter_tokens(engine_cls, monkeypatch):
    step = engine_cls._step
    calls = {"n": 0}

    def altered(self):
        out = step(self)
        calls["n"] += 1
        if calls["n"] % 3 == 0:       # a token altered where it is made
            out[0].copy_((out[0] + 7) % self.cfg.vocab)
        return out
    monkeypatch.setattr(engine_cls, "_step", altered)


def _state_unchanged(engine_cls, monkeypatch):
    def unchanged(self):              # no model run: the last token again
        act = self._active
        self._budget.copy_(torch.where(act, self._budget - 1, self._budget))
        done = act & (self._budget <= 0)
        self._active.copy_(act & ~done)
        self._out[0].copy_(self._last[:, 0])
        self._out[1].copy_(done)
        return self._out
    monkeypatch.setattr(engine_cls, "_step", unchanged)


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged])
def test_serving_faults_are_not_correct(fault, monkeypatch):
    from repro_torch.serving.engine import GenerationEngine
    fault(GenerationEngine, monkeypatch)
    out = run("tiny-dense.chat_tiny")
    assert not out["correct"]
    assert out["checks"]["served_gap"]["value"] > \
        out["checks"]["served_gap"]["limit"]


def _unchanged_params(make):
    def faulty(*a, **kw):
        step = make(*a, **kw)

        def train_step(params, opt, batch):
            keep = {k: v for k, v in _flat(params)}
            saved = {k: v.detach().clone() for k, v in keep.items()}
            params, opt, metrics = step(params, opt, batch)
            with torch.no_grad():
                for k, v in keep.items():
                    v.copy_(saved[k])
            return params, opt, metrics
        return train_step
    return faulty


def _half_batch(make):
    def faulty(*a, **kw):
        step = make(*a, **kw)

        def train_step(params, opt, batch):
            half = {k: v[:v.shape[0] // 2].repeat_interleave(2, 0)
                    for k, v in batch.items()}
            return step(params, opt, half)
        return train_step
    return faulty


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("fault", [_unchanged_params, _half_batch])
def test_training_faults_are_not_correct(fault, monkeypatch):
    import repro_torch.training as training
    monkeypatch.setattr(training, "make_train_step",
                        fault(training.make_train_step))
    out = run("tiny-vlm.train_tiny")
    assert not out["correct"], out["checks"]


def test_serving_control_fails_the_limit():
    from harness.manifest import reference
    from reference.common import precise
    c = tiny("tiny-dense.chat_tiny")
    Ref = reference(c).Ref
    sc = serve.ServeCell(c, SEED, CPU, log=lambda m: None)
    try:
        win = sc.window(SEED, 1.5)
        picks, _ = check.sample(win, int(sc.dep["max_len"]), sc.warmed,
                                SEED, {"served_tokens": 60,
                                       "min_requests": 8,
                                       "cross_section": 3})
    finally:
        sc.close()
    precise()
    model = c.config["model"]
    prog = check.served_gaps(Ref(model), sc.weights, picks, CPU)
    ctrl = check.served_gaps(Ref(model), sc.weights, picks, CPU,
                             control=Ref(model, "fp8"))
    limit = c.limits["served_gap"]["limit"]
    assert max(prog) <= limit < max(ctrl)


def test_training_control_fails_a_limit():
    from harness.train import loss_gap, reference_numbers
    c = tiny("tiny-vlm.train_tiny")
    ref = reference_numbers(c.config, c.mix, SEED, CPU)
    ctl = reference_numbers(c.config, c.mix, SEED, CPU, precision="fp8")
    gaps = {"loss_gap": loss_gap(ctl["losses"], ref["losses"]),
            "grad_gap": check.leaf_gap(ctl["grad1"], ref["grad1"])[0],
            "change_gap": check.leaf_gap(ctl["change"], ref["change"],
                                         check.moved_leaves(ref["grad1"]))[0]}
    assert any(v > c.limits[k]["limit"] for k, v in gaps.items()), gaps


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen2-7b.chat", "internvl2-2b.train_4k"])
def test_control_fails_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs the card: the control runs at the cell's size")
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
    import control
    c = load_cell(name)
    seeds = [2 ** 32 + 11, 2 ** 32 + 12, 2 ** 32 + 13]
    dev = torch.device("cuda")
    if c.mix["kind"] == "train":
        rows = control.train_readings(c, seeds, dev, program=False)
        for r in rows:
            assert any(v > c.limits[k]["limit"]
                       for k, v in r["control"].items()), r
    else:
        rows = control.serve_readings(c, seeds, 10.0, dev)
        for r in rows:
            assert r["program"] <= c.limits["served_gap"]["limit"] \
                < r["control"], r
