"""BENCHMARK.json keeps to its required form, and every cell's files are
found by name: configuration, traffic, loop, limits and each per-layer
metric's reader; a cell added as files in a copy is found with no edit."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
        "per_layer"}


def test_top_level_keys_and_command():
    assert set(SPEC) == KEYS
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_texts():
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        names.append(("config", c["name"]))
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        names.append(("cell", w["name"]))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        names.append(("metric", m["name"]))
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert TEXT.match(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in SPEC["end_to_end"])


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = [m for m in SPEC["per_layer"] if w["name"] in m["workloads"]]
        assert layers and all(m["moves"] in e2e for m in layers)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_files_are_found_by_name(cell):
    from benchmark.harness import find_cell

    found = find_cell(ROOT, cell)
    assert (found["loop"] / f"{found['traffic']['loop']}.py").is_file()
    assert set(found["limits"]) and all(v >= 0 for v in found["limits"].values())
    for m in found["per_layer"]:
        assert (found["metrics"] / f"{m['name']}.py").is_file()


def test_a_cell_added_as_files_is_found(tmp_path):
    """A new cell is a traffic file, a limits file and an entry, and a new
    metric a reader file and an entry: the harness finds them without an
    edit to any other file."""
    from benchmark.harness import find_cell

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = tmp_path / "benchmark"
    traffic = json.loads((bench / "traffic" / "fit100.json").read_text())
    (bench / "traffic" / "fit25.json").write_text(
        json.dumps(dict(traffic, restart_steps=25)))
    shutil.copy(bench / "limits" / "gamma-train.json",
                bench / "limits" / "gamma-train25.json")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "gamma-train25", "config": "gamma-800x600-d5",
                              "traffic": "fit25", "chips": 1, "why": "test"})
    shutil.copy(bench / "metrics" / "idle_pct.train.py",
                bench / "metrics" / "idle_pct.any.py")
    spec["per_layer"].append({"name": "idle_pct.any", "unit": "%", "better": "lower",
                              "source": "device_trace", "layer": "device",
                              "moves": "setup_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    found = find_cell(tmp_path, "gamma-train25")
    assert found["traffic"]["restart_steps"] == 25
    assert [m["name"] for m in found["end_to_end"]] == ["peak_gib", "setup_s"]
    assert [m["name"] for m in found["per_layer"]] == ["idle_pct.any"]
    assert (found["metrics"] / "idle_pct.any.py").is_file()
