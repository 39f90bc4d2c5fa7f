"""Find a cell's pieces by name: ``BENCHMARK.json`` names the cell, its
configuration (``vcbench/configs/<config>.json``), its traffic mix
(``vcbench/mixes/<traffic>.json``), its correctness limits
(``vcbench/limits/<workload>.json``) and its metrics, each per-layer
metric read by ``vcbench/metrics/<metric>.py``. Adding a cell, a mix or a
metric adds files and entries; no file here needs an edit."""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]      # vcbench/
ROOT = BENCH_DIR.parent                               # the checkout


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
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"vcbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
