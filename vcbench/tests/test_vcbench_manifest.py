"""``BENCHMARK.json`` keeps to the benchmark's contract: its keys, names
and units, its pieces found by name under ``vcbench/``, its bounds."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
WIDTHS = re.compile(r"(hidden|intermediate|latent|state|proj|head|expan|"
                    r"_dim$|_rank$|experts_per_tok)")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "vcbench/run.py"]
    assert BENCH["paths"] == ["vcbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200 or cells < 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end" and key != "source":
                    assert LINE.match(e[key]), e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        n = [e["name"] for e in BENCH[group]]
        assert len(n) == len(set(n))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_configs_found_by_name():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"vcbench/configs/{c['name']}.json"
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]
        assert not any(WIDTHS.search(k) for k in c["reduced"])
        assert c["source"].startswith("https://")


def test_cells_find_their_files():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / "vcbench/mixes" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "vcbench/limits" / f"{w['name']}.json").is_file()
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == configs


def _cells(metric):
    return metric.get("workloads", [w["name"] for w in BENCH["workloads"]])


def test_metrics_and_what_they_move():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e
        assert (ROOT / "vcbench/metrics" / f"{m['name']}.py").is_file()
        for cell in _cells(m):
            assert cell in _cells(e2e[m["moves"]]), (m["name"], cell)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert all(LINE.match(x) for x in layers)
    for w in BENCH["workloads"]:
        reported = [m for m in BENCH["end_to_end"]
                    if w["name"] in _cells(m)]
        assert len(reported) >= 2
        assert any(w["name"] in _cells(m) for m in BENCH["per_layer"])


@pytest.mark.parametrize("w", [w["name"] for w in BENCH["workloads"]])
def test_each_roofline_has_a_step_mfu_beside_it(w):
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") and w in _cells(m):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       and w in _cells(o) for o in BENCH["per_layer"])
