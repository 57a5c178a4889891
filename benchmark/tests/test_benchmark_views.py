"""The multi-view cells: balls4-turntable8-train (the SPD flake fitted from
an 8-view turntable, loop fit_views) and gamma3-train (BASELINE config 3's
fit) are found by name with the metrics they report; the traffic's poses
are the turntable the program's camera module makes; the new loop runs
whole at a tiny size on the CPU, traced and untraced; the two readers read
the program's recorder, and nothing from a program without it; the fault
"one view left out" fails the cell's limits at the tiny size; and the
reference's posed module imports neither JAX nor the program."""

from __future__ import annotations

import json
import math
import shutil

import pytest
import torch

from conftest import ROOT
from test_benchmark_isolation import JAX_SIDE, imported_top_levels, sources
from test_benchmark_rehearsal import rehearse

from benchmark.harness import find_cell, load_module
from benchmark.reference import views

TURNTABLE = "balls4-turntable8-train"
NEW_READERS = ("bvh_builds_pct.views", "view_host_ms.views")


def test_both_cells_are_found_by_name():
    gamma3 = find_cell(ROOT, "gamma3-train")
    assert gamma3["cell"]["chips"] == 1 and gamma3["config"]["name"] == "gamma-640x480-d4"
    r = gamma3["config"]["render"]
    assert (r["width"], r["height"], r["alias_factor"], r["max_depth"]) == (640, 480, 3, 4)
    gamma = json.loads((ROOT / "benchmark/configs/gamma-800x600-d5.json").read_text())
    assert gamma3["config"]["scene"] == gamma["scene"] and gamma3["config"]["reduced"] == []
    assert gamma3["traffic"]["loop"] == "fit" and gamma3["traffic"]["restart_steps"] == 100
    assert set(gamma3["limits"]) == {"loss_gap", "grad_gap", "change_gap"}
    assert {m["name"] for m in gamma3["per_layer"]} == {
        "idle_pct.train", "host_ms.train", "k2_roofline", "mfu.train",
        "step_host_ms.train", "update_ms.train", "launch_ms.train", "kernel_load_s"}

    turn = find_cell(ROOT, TURNTABLE)
    assert turn["cell"]["chips"] == 1 and turn["config"]["name"] == "spd-balls4-512-d5"
    t = turn["traffic"]
    assert t["loop"] == "fit_views" and t["views"]["count"] == 8
    assert (t["restart_steps"], t["check_steps"], t["learning_rate"]) == (10, 2, 5e-5)
    assert "views" in t["assumed"]
    assert set(turn["limits"]) == {"loss_gap", "loss1_gap", "grad_gap", "change_gap",
                                   "change_med_gap"}
    assert {m["name"] for m in turn["per_layer"]} == {
        "idle_pct.train", "host_ms.train", "step_host_ms.train", "update_ms.train",
        "k3_ms.train", "k4_ms.train", "k3_live_pct.train", "inplace_pct.train",
        "kernel_load_s", *NEW_READERS}
    for found in (gamma3, turn):
        assert [m["name"] for m in found["end_to_end"]] == [
            "train_mrays_per_s", "peak_gib", "setup_s"]


def test_the_turntable_is_the_programs():
    """The traffic's float32 poses: view 0 the identity (the scene lies in
    its frame), every eye as far from the look-at point as the SPD's, each
    rotation orthonormal, and each pose the program's camera.turntable of
    the identity about the same axis and pivot, bit for bit."""
    import numpy as np

    from raytpu_torch.camera import View, turntable

    spec = json.loads((ROOT / "benchmark/traffic/fit10-turntable8.json").read_text())["views"]
    poses = views.traffic_views(spec, "cpu")
    assert len(poses) == 8
    assert torch.equal(poses[0][0].abs(), torch.eye(3)) and not poses[0][1].any()
    rot0, eye0 = views.look_at(spec["from"], spec["at"], spec["up"])
    dist = math.sqrt(sum(e * e for e in eye0))
    for r, e in poses:
        assert torch.allclose(r @ r.T, torch.eye(3), atol=1e-6)
        centre = views._apply(rot0, [-x for x in eye0])  # the look-at point
        assert abs(math.dist(e.tolist(), centre) - dist) < 1e-5
    axis = views._apply(rot0, spec["axis"])
    pivot = views._apply(rot0, [p - x for p, x in zip(spec["pivot"], eye0)])
    ours = turntable(View.identity(), 8, axis, pivot)
    for (r, e), v in zip(poses, ours):
        assert np.array_equal(r.numpy(), v.rotation) and np.array_equal(e.numpy(), v.eye)
    spd = View.look_at(spec["from"], spec["at"], spec["up"])
    r0, e0 = views._float32(views.look_at(spec["from"], spec["at"], spec["up"]), "cpu")
    assert np.array_equal(r0.numpy(), spd.rotation) and np.array_equal(e0.numpy(), spd.eye)


def test_targets_are_seeded_per_view():
    traffic = json.loads((ROOT / "benchmark/traffic/fit10-turntable8.json").read_text())
    render = dict(width=8, height=4)
    a = views.targets(render, traffic, 2 ** 31 + 5, 3, "cpu")
    assert a.shape == (3, 32, 3) and 0 <= float(a.min()) and float(a.max()) < 1e-3
    assert torch.equal(a, views.targets(render, traffic, 2 ** 31 + 5, 3, "cpu"))
    assert not torch.equal(a[0], a[1])
    assert not torch.equal(a, views.targets(render, traffic, 2 ** 31 + 6, 3, "cpu"))


def _reader(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                       f"test_metric_{name}")


@pytest.mark.parametrize("spans, counters, want", [
    ({"wf.bvh": {"count": 10}}, {"views.rendered": 80}, 12.5),
    ({"wf.bvh": {"count": 80}}, {"views.rendered": 80}, 100.0),
    ({}, {"views.rendered": 8}, 0.0),
    # No view rendered (a program without the multi-view step).
    ({"wf.bvh": {"count": 10}}, {"wf.slots": 4}, None)])
def test_the_build_share_reads_the_recorder(monkeypatch, spans, counters, want):
    from raytpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: spans)
    monkeypatch.setattr(profiling, "counters", lambda: counters)
    assert _reader("bvh_builds_pct.views").read(None) == want


@pytest.mark.parametrize("spans, want", [
    ({"views.view": {"count": 8, "total_ns": 20_000_000}}, 2.5),
    ({"fit.step": {"count": 8, "total_ns": 20_000_000}}, None)])
def test_the_view_host_time_reads_the_recorder(monkeypatch, spans, want):
    from raytpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "spans", lambda: spans)
    assert _reader("view_host_ms.views").read(None) == want


@pytest.mark.parametrize("name", NEW_READERS)
def test_the_readers_read_nothing_without_a_recorder(monkeypatch, name):
    from raytpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    assert _reader(name).read(None) is None


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with tiny-turntable: balls4-turntable8-train
    on the flake's first 10 spheres at 20x12, alias 1, depth 3, from 3 views
    of the turntable (the count is the traffic's: each turned 120 degrees)."""
    root = tmp_path_factory.mktemp("views")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    c = json.loads((bench / "configs" / "spd-balls4-512-d5.json").read_text())
    c["render"].update(width=20, height=12, alias_factor=1, max_depth=3)
    c["scene"]["spheres"] = c["scene"]["spheres"][:10]
    c["reference"]["block_pixels"] = 64
    (bench / "configs" / "tiny-turntable.json").write_text(json.dumps(c))
    traffic = json.loads((bench / "traffic" / "fit10-turntable8.json").read_text())
    traffic["views"]["count"] = 3
    (bench / "traffic" / "tiny-turntable.json").write_text(json.dumps(traffic))
    spec["configs"].append({"name": "tiny-turntable", "source": "test", "reduced": [],
                            "file": "benchmark/configs/tiny-turntable.json",
                            "why": "a CPU rehearsal"})
    cell = next(x for x in spec["workloads"] if x["name"] == TURNTABLE)
    spec["workloads"].append(dict(cell, name="tiny-turntable", config="tiny-turntable",
                                  traffic="tiny-turntable"))
    shutil.copy(bench / "limits" / f"{TURNTABLE}.json",
                bench / "limits" / "tiny-turntable.json")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if TURNTABLE in m.get("workloads", []):
            m["workloads"].append("tiny-turntable")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_turntable_rehearsal_runs_whole(tiny_root, trace, capsys):
    from benchmark import harness

    found, res = rehearse(tiny_root, "tiny-turntable", trace)
    assert harness.finish(*res) == 0
    out = capsys.readouterr()
    line = json.loads(out.out.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0, line["check"]
    names = [m["name"] for m in (found["per_layer"] if trace else found["end_to_end"])]
    assert set(line["metrics"]) <= set(names)
    if trace:
        # The CPU's "auto" is the eager tracer: no tree, no K3 slot; the
        # multi-view step's span still reads.
        assert "view_host_ms.views" in line["metrics"]
        assert "bvh_builds_pct.views" in line["metrics"]
    else:
        assert set(line["metrics"]) == set(names)
        # Each step's rays are the three views' frames.
        assert line["metrics"]["train_mrays_per_s"]["value"] > 0
    assert set(line["check"]) == set(found["limits"])
    assert "reading max_opacity" in out.err or line["attempted"] < 8


def test_one_view_left_out_fails_the_limits(tiny_root):
    """The reference's fit with the last view left out of every step reads
    outside the cell's limits at the tiny size, and so does the one with
    half of each view's pixels left out."""
    from benchmark import compare, control_views

    found = find_cell(tiny_root, "tiny-turntable")
    got = control_views.training(found, 2 ** 31 + 11, torch.device("cpu"),
                                 ("leftout", "half"))
    for variant in ("leftout", "half"):
        assert not compare.judge(got[variant], found["limits"]), (variant, got[variant])


def test_the_posed_reference_imports_neither_jax_nor_the_program():
    path = ROOT / "benchmark" / "reference" / "views.py"
    assert path in sources("reference")
    assert imported_top_levels(path) <= {"__future__", "contextlib", "math", "torch",
                                         "benchmark"}
    assert not imported_top_levels(path) & (JAX_SIDE | {"raytpu_torch"})
    for other in ("loops/fit_views.py", "control_views.py"):
        assert not imported_top_levels(ROOT / "benchmark" / other) & JAX_SIDE
