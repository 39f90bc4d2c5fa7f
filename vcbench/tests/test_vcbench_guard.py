"""No module the benchmark loads on the card is JAX or the JAX package,
compared by whole top-level names; the reference imports nothing of the
program; nothing under ``vcbench/`` reads the JAX package's benchmarks."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from harness.guard import forbidden_modules

ROOT = Path(__file__).resolve().parents[2]
SOURCES = sorted((ROOT / "vcbench").rglob("*.py"))


@pytest.mark.parametrize("name,bad", [
    ("jax", True), ("jax.numpy", True), ("jaxlib.xla_client", True),
    ("flax.linen", True), ("repro", True), ("repro.core.cluster", True),
    ("repro_torch", False), ("repro_torch.core", False), ("jaxtyping", False),
    ("reprox", False), ("numpy", False)])
def test_whole_top_level_names(name, bad):
    assert (forbidden_modules([name]) == [name]) is bad


def _roots(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_file_imports_jax_or_the_benchmarks(path):
    roots = set(_roots(path))
    assert not roots & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
    if "reference" in path.parts:
        assert "repro_torch" not in roots and "harness" not in roots


def test_a_run_loads_no_jax():
    code = (
        "import sys; sys.path[:0] = ['vcbench', 'src'];"
        "import torch, repro_torch.serving, repro_torch.training,"
        " repro_torch.core;"
        "import harness.cell, harness.serve, harness.train, reference.model;"
        "from harness.guard import forbidden_modules;"
        "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_the_program(tmp_path):
    (tmp_path / "vcbench").mkdir()
    for p in (ROOT / "vcbench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            dst = tmp_path / p.relative_to(ROOT)
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_bytes(p.read_bytes())
    (tmp_path / "BENCHMARK.json").write_bytes(
        (ROOT / "BENCHMARK.json").read_bytes())
    out = subprocess.run(
        [sys.executable, "vcbench/run.py", "--workload", "qwen2-7b.chat",
         "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "vcbench/run.py", "--workload", "qwen2-7b.chat",
         "--seed", str(2 ** 33), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(ROOT / ".vcbench_cache")})
    assert out.returncode != 0 and out.stdout.strip() == ""
