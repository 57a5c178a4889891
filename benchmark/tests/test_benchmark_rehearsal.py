"""A CPU rehearsal of each tiny cell drives a whole run (the program's
plain versions, the window, the traced run's readers, the reference and
the comparison) and prints the result line; the entry point refuses
to run without a card, and without the program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from conftest import ROOT

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def rehearse(root, cell, trace=0, seed=2 ** 31 + 11, seconds=0.3):
    from benchmark import harness

    found = harness.find_cell(root, cell)
    args = harness.parse(["--workload", cell, "--seed", str(seed), "--seconds",
                          str(seconds), "--trace", str(trace)])
    return found, harness.run_rank(found, args, 0, 1, torch.device("cpu"),
                                   time.perf_counter())


@pytest.mark.parametrize("cell", ["tiny-train", "tiny-frame", "tiny-wavefront"])
@pytest.mark.parametrize("trace", [0, 1])
def test_rehearsal_prints_the_result_line(tiny_root, cell, trace, capsys):
    from benchmark import harness

    found, res = rehearse(tiny_root, cell, trace)
    assert harness.finish(*res) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = KEYS + (["breakdown"] if trace else []) + ["check"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    names = [m["name"] for m in (found["per_layer"] if trace else found["end_to_end"])]
    assert set(line["metrics"]) <= set(names)
    if not trace:
        assert set(line["metrics"]) == set(names)
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    dev = line["device"]
    assert dev["count"] == 1 and dev["platform"] == "cpu"
    if trace:
        assert dev["busy_s"] > 0 and dev["window_s"] > 0
        assert len(line["breakdown"]["device_ops"]) <= 10
        assert len(line["breakdown"]["idle_gaps"]) <= 10
    assert set(line["check"]) == set(found["limits"])


def test_same_seed_same_inputs(tiny_root):
    from benchmark import inputs

    found, _ = rehearse(tiny_root, "tiny-wavefront", seconds=0.05)
    a = inputs.scene_leaves(found["config"], 2 ** 33 + 1, "cpu")
    b = inputs.scene_leaves(found["config"], 2 ** 33 + 1, "cpu")
    c = inputs.scene_leaves(found["config"], 2 ** 33 + 2, "cpu")
    # The configuration fixes its scene: the seed moves the target only.
    assert all(torch.equal(a[k], b[k]) and torch.equal(a[k], c[k]) for k in a)
    t = [inputs.target(found["config"]["render"], found["traffic"], s, "cpu")
         for s in (5, 5, 6)]
    assert torch.equal(t[0], t[1]) and not torch.equal(t[0], t[2])


def test_entry_point_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "gamma-frame", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_refuses_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and benchmark/, a run has no
    program to drive and exits with an error, printing no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time, torch\n"
            f"sys.path.insert(0, {str(tmp_path)!r})\n"
            "from pathlib import Path\n"
            "from benchmark import harness\n"
            f"found = harness.find_cell(Path({str(tmp_path)!r}), 'gamma-frame')\n"
            "args = harness.parse(['--workload', 'gamma-frame', '--seed', '1', '--seconds', '1'])\n"
            "harness.finish(*harness.run_rank(found, args, 0, 1, torch.device('cpu'), 0.0))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "raytpu_torch" in out.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "gamma-frame", "--seed", "12345", "--seconds", "1",
                          "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
