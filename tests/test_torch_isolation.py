"""The PyTorch port stands alone: no file of ``src/repro_torch``, of the
port's examples and tools, nor ``chip_smoke.py`` imports JAX or the JAX
package, importing the port loads no JAX, and its entry points refuse to
run quietly on the CPU when no card is present and the caller did not ask
for the CPU."""
import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced
from repro_torch.models import init_params
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.train import main as train_main
from repro_torch.serving import GenerationEngine, generate
from repro_torch.training import (OptimizerConfig, make_opt_state,
                                  make_train_step)

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((REPO / "src" / "repro_torch").rglob("*.py"))
              + sorted((REPO / "examples").glob("*_torch.py"))
              + sorted((REPO / "tools").glob("*_torch.py"))
              + [REPO / "chip_smoke.py"])
FORBIDDEN = ("jax", "jaxlib", "repro")
NEW_EXAMPLES = ("quickstart_torch", "elastic_failover_torch",
                "isolation_check_torch")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_files_exist():
    names = {p.relative_to(REPO).as_posix() for p in PORT_FILES}
    assert "src/repro_torch/serving/engine.py" in names
    assert "src/repro_torch/serving/host.py" in names
    assert "src/repro_torch/core/cluster.py" in names
    assert "src/repro_torch/kernels/flash_attention/kernel.py" in names
    assert "src/repro_torch/kernels/flash_decode/kernel.py" in names
    for kernel in ("rwkv6_scan", "mamba_scan", "grouped_gemm"):
        for module in ("ref", "ops", "kernel"):
            assert f"src/repro_torch/kernels/{kernel}/{module}.py" in names
        assert (REPO / "src" / "repro_torch" / "kernels" / kernel / "csrc"
                / f"{kernel}.cu").is_file()
    for module in ("rwkv6", "mamba", "moe"):
        assert f"src/repro_torch/models/{module}.py" in names
    for module in ("training/optimizer", "training/step", "data/pipeline",
                   "ckpt/checkpoint", "launch/train", "launch/serve"):
        assert f"src/repro_torch/{module}.py" in names
    assert "examples/serve_multitenant_torch.py" in names
    assert "examples/train_tenant_job_torch.py" in names
    for example in NEW_EXAMPLES:
        assert f"examples/{example}.py" in names
    for module in ("sharding/api", "sharding/planner", "sharding/collectives",
                   "training/grad_compress", "launch/mesh", "launch/specs",
                   "launch/spmd", "launch/dryrun", "roofline/analysis",
                   "roofline/trace_cost"):
        assert f"src/repro_torch/{module}.py" in names
    assert "tools/planted_faults_torch.py" in names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: p.relative_to(REPO).as_posix())
def test_no_jax_or_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_loads_no_jax():
    code = ("import sys\n"
            "import repro_torch.serving, repro_torch.models.convert\n"
            "import repro_torch.kernels.flash_attention.kernel\n"
            "import repro_torch.kernels.flash_decode.ops\n"
            "import repro_torch.kernels.rwkv6_scan.kernel\n"
            "import repro_torch.kernels.mamba_scan.kernel\n"
            "import repro_torch.models.rwkv6, repro_torch.models.mamba\n"
            "import repro_torch.models.moe\n"
            "import repro_torch.core, repro_torch.serving.host\n"
            "import repro_torch.training, repro_torch.data, repro_torch.ckpt\n"
            "import repro_torch.launch.train, repro_torch.launch.serve\n"
            "import repro_torch.sharding.planner, repro_torch.launch.spmd\n"
            "import repro_torch.launch.mesh, repro_torch.launch.specs\n"
            "import repro_torch.training.grad_compress\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_the_card(no_cuda):
    cfg = reduced(get_config("qwen2-7b"), n_layers=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_params(cfg, generator=torch.Generator())
    params = init_params(cfg, generator=torch.Generator().manual_seed(0),
                         device="cpu", dtype=torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerationEngine(cfg, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GenerationEngine(cfg, params, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate(cfg, params, np.zeros((1, 4), np.int32), max_new_tokens=2,
                 max_len=16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve_main(["--reduced", "--requests", "1"])
    # asking for the CPU works
    eng = GenerationEngine(cfg, params, device="cpu", max_len=16)
    assert eng.cache["sub0"]["k"].device.type == "cpu"
    assert train_main(["--reduced", "--steps", "1", "--batch", "2",
                       "--seq", "8", "--device", "cpu"]) == 0
    assert serve_main(["--reduced", "--requests", "2", "--max-new", "2",
                       "--max-len", "32", "--device", "cpu"]) == 0
    # the train step runs where the parameters are: CPU parameters train
    # on the CPU, and nothing moves to the card
    step = make_train_step(cfg, OptimizerConfig())
    _, opt, metrics = step(params, make_opt_state(params),
                           {"tokens": np.zeros((2, 8), np.int32)})
    assert opt["step"].device.type == "cpu"
    assert all(m.device.type == "cpu" for m in metrics.values())


def test_chip_smoke_refuses_to_run_without_a_card():
    """No card: the smoke script exits non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, str(REPO / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NEW_EXAMPLES)
def test_new_examples_default_to_the_card(no_cuda, name):
    """Without ``--device cpu`` each example asks for the card and, with
    none, raises; none switches to the CPU quietly (the isolation check
    needs 8 GPUs and says so)."""
    with pytest.raises(RuntimeError, match="CUDA is not available|8 GPUs"):
        _example(name).main([])


@pytest.mark.parametrize("name", NEW_EXAMPLES)
def test_new_examples_run_on_the_cpu(name):
    """``--device cpu``: each ends in "done" (the isolation check on 8 gloo
    ranks, the failover's checkpoints in a fresh temporary directory)."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable, str(REPO / "examples" / f"{name}.py"),
                          "--device", "cpu"], env=env, capture_output=True,
                         text=True, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "done"
    if name == "isolation_check_torch":
        assert "correctly rejected" in res.stdout
