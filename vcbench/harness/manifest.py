"""Find a cell's pieces by name: ``BENCHMARK.json`` names the cell, its
configuration (``vcbench/configs/<config>.json``), its traffic mix
(``vcbench/mixes/<traffic>.json``), its correctness limits
(``vcbench/limits/<workload>.json``) and its metrics, each per-layer
metric read by ``vcbench/metrics/<metric>.py``. A configuration names its
reference module, which holds all that depends on the architecture
(``reference(...)``; the contract is in ``vcbench/reference/model.py``).
Adding a cell, a mix, a metric or an architecture adds files and
entries; no file here needs an edit."""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional, Union

BENCH_DIR = Path(__file__).resolve().parents[1]      # vcbench/
ROOT = BENCH_DIR.parent                               # the checkout
DEFAULT_REFERENCE = "vcbench/reference/model.py"


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    layer: str = ""
    moves: str = ""
    bound: Optional[float] = None
    workloads: Optional[List[str]] = None

    def applies_to(self, workload: str) -> bool:
        return self.workloads is None or workload in self.workloads


@dataclass
class Cell:
    """One entry of ``workloads`` with everything it names."""
    name: str
    config_name: str
    traffic: str
    chips: int
    config: Dict[str, Any]
    mix: Dict[str, Any]
    limits: Dict[str, Any]
    end_to_end: List[Metric] = field(default_factory=list)
    per_layer: List[Metric] = field(default_factory=list)


def _metrics(entries: List[Dict[str, Any]], workload: str) -> List[Metric]:
    out = [Metric(**e) for e in entries]
    return [m for m in out if m.applies_to(workload)]


def load_cell(workload: str, manifest_path: Optional[Path] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` (or of another manifest,
    with its mixes and limits under ``bench_dir``); a name it lacks raises
    ``KeyError``."""
    bench = load_json(manifest_path or ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    return Cell(
        name=workload, config_name=entry["config"],
        traffic=entry["traffic"], chips=int(entry["chips"]),
        config=load_json(ROOT / conf["file"]),
        mix=load_json(bench_dir / "mixes" / f"{entry['traffic']}.json"),
        limits=load_json(bench_dir / "limits" / f"{workload}.json"),
        end_to_end=_metrics(bench["end_to_end"], workload),
        per_layer=_metrics(bench["per_layer"], workload))


def metric_reader(name: str) -> Callable[[Any], Optional[float]]:
    """``read(run)`` of ``vcbench/metrics/<name>.py`` (a metric's name may
    hold dots, so the file is loaded by its path)."""
    return _load(BENCH_DIR / "metrics" / f"{name}.py",
                 f"vcbench_metric_{name.replace('.', '_').replace('-', '_')}"
                 ).read


def _load(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


_REFERENCES: Dict[str, ModuleType] = {}


def reference(what: Union[Cell, Dict[str, Any]]) -> ModuleType:
    """The reference module that a cell's configuration (or a configuration
    file's dict) names under ``"reference"``, a path from the checkout;
    without the key, ``vcbench/reference/model.py``. Loaded by its path
    once and kept (a training step's batch asks for it again, so a call
    after the first touches no file). A configuration that the module does
    not cover stops here, with an error that names both."""
    config = what.config if isinstance(what, Cell) else what
    rel = config.get("reference", DEFAULT_REFERENCE)
    mod = _REFERENCES.get(rel)
    if mod is None:
        path = (ROOT / rel).resolve()
        if ROOT not in path.parents or not path.is_file():
            raise ValueError(f"configuration {config.get('name')!r}: its "
                             f"reference {rel!r} is no file of the checkout")
        name = "vcbench_reference_" + "".join(
            c if c.isalnum() else "_" for c in str(path.relative_to(ROOT)))
        mod = _REFERENCES[rel] = _load(path, name)
    lacks = mod.unsupported(config["model"])
    if lacks is not None:
        key = ("its \"reference\" key" if "reference" in config
               else "no \"reference\" key, so the default")
        raise NotImplementedError(
            f"configuration {config.get('name')!r} ({key}: {rel}): the "
            f"reference module does not cover {lacks}; name a reference "
            f"module that does in the configuration's \"reference\" key")
    return mod
