"""The sphereflake cell (balls4-train) and the four-chip config-5 cell
(rand256-train-x4): their files are found by name, balls4-train reports the
in-place share, whose reader reads the program's counters (and nothing
from a program without them), and CPU rehearsals run whole: balls4-train
at a tiny size, its scene cut to the flake's first spheres, and
rand256-train-x4 at a tiny size over four gloo ranks."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from conftest import ROOT
from test_benchmark_rehearsal import rehearse

from benchmark.harness import find_cell, load_module

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
INPLACE = "inplace_pct.train"


def test_both_cells_are_found_by_name():
    balls = find_cell(ROOT, "balls4-train")
    assert balls["cell"]["chips"] == 1
    assert len(balls["config"]["scene"]["spheres"]) == 7381
    assert balls["config"]["reduced"] == ["floor_polygon"]
    assert INPLACE in [m["name"] for m in balls["per_layer"]]
    x4 = find_cell(ROOT, "rand256-train-x4")
    assert x4["cell"]["chips"] == 4 and x4["config"]["name"] == "rand256-1080p-d6"
    # Both rates spread wider than the large-scene rate's bound admits, so
    # both are judged under the dense fit cells' rate and its bound.
    for found in (balls, x4):
        assert [m["name"] for m in found["end_to_end"]] == [
            "train_mrays_per_s", "peak_gib", "setup_s"]
    # fit10's content under its own name: a (configuration, traffic) pair
    # appears once.
    fit10 = json.loads((ROOT / "benchmark" / "traffic" / "fit10.json").read_text())
    assert x4["traffic"] == fit10
    assert INPLACE not in [m["name"] for m in x4["per_layer"]]
    # K3's and K4's device time and K3's live share read in both cells
    # under the rate they are judged by; the exchange's time on four ranks.
    for found in (balls, x4):
        names = [m["name"] for m in found["per_layer"]]
        assert {"k3_ms.train", "k4_ms.train", "k3_live_pct.train"} <= set(names)
        assert ("allreduce_ms.train" in names) == (found is x4)
    for found in (balls, x4):
        assert set(found["limits"]) == {"loss_gap", "loss1_gap", "grad_gap",
                                        "change_gap", "change_med_gap"}


def reader():
    return load_module(ROOT / "benchmark" / "metrics" / f"{INPLACE}.py",
                       "test_metric_inplace")


@pytest.mark.parametrize("counters, want", [
    ({"wf.slots": 300, "wf.bwd_slots": 100, "wf.slots_inplace": 300,
      "wf.bwd_slots_inplace": 100}, 100.0),
    ({"wf.slots": 300, "wf.bwd_slots": 100, "wf.slots_inplace": 300}, 75.0),
    ({"wf.slots": 300, "wf.bwd_slots": 100}, 0.0),
    ({"wf.bwd_slots": 0}, 0.0),
    # A program that counts no K4 slots (the parent of these counters).
    ({"wf.slots": 300, "wf.live": 200}, None)])
def test_the_inplace_share_reads_the_recorder(monkeypatch, counters, want):
    from raytpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", lambda: counters)
    assert reader().read(None) == want


def test_the_inplace_share_reads_nothing_without_a_recorder(monkeypatch):
    from raytpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert reader().read(None) is None


@pytest.mark.parametrize("counters, want", [
    ({"wf.slots": 400, "wf.live": 78}, 19.5),
    ({"wf.slots": 400}, 0.0),
    # No K3 slot launched: nothing to read.
    ({"wf.live": 3}, None)])
def test_the_live_share_of_the_fit_cells_reads_the_recorder(monkeypatch, counters,
                                                           want):
    from raytpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", lambda: counters)
    live = load_module(ROOT / "benchmark" / "metrics" / "k3_live_pct.train.py",
                       "test_metric_live_train")
    assert live.read(None) == want
    monkeypatch.delattr(profiling, "counters")
    assert live.read(None) is None


def _view(kernel_ns_by_rank, steps=10):
    from benchmark.trace import TraceView

    return TraceView([{"kernel_ns": k, "steps": steps} for k in kernel_ns_by_rank],
                     {})


@pytest.mark.parametrize("name, want", [("k3_ms.train", 5.5), ("k4_ms.train", 12.0),
                                        ("allreduce_ms.train", 3.0)])
def test_the_fit_cells_device_readers_read_by_kernel_name(name, want):
    """Each rank's time a step in the kernels named, averaged over ranks;
    nothing where none ran."""
    k3 = "void (anonymous namespace)::wf_level_kernel<3>(float const*, int)"
    k4 = ("void (anonymous namespace)::wf_level_bwd_kernel<false, false, true>"
          "(float const*)")
    nccl = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
    ranks = [{k3: 50_000_000, k4: 110_000_000, nccl: 20_000_000, "other": 7},
             {k3: 60_000_000, k4: 130_000_000, nccl: 40_000_000}]
    metric = load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                         f"test_metric_{name}")
    assert metric.read(_view(ranks)) == pytest.approx(want)
    assert metric.read(_view([{"other": 7}])) is None


# (name, base cell, base configuration, render sizes, the first spheres kept)
TINY = [("tiny-balls", "balls4-train", "spd-balls4-512-d5", (20, 12, 1, 3), 10),
        ("tiny-x4", "rand256-train-x4", "rand256-1080p-d6", (20, 12, 1, 3), 12)]


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with the TINY cells: tiny-balls, balls4-train
    on the flake's first 10 spheres, and tiny-x4, rand256-train-x4 over 12
    spheres, each at 20x12, alias 1, depth 3."""
    root = tmp_path_factory.mktemp("balls")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    for name, base, config, (w, h, a, d), spheres in TINY:
        c = json.loads((bench / "configs" / f"{config}.json").read_text())
        c["render"].update(width=w, height=h, alias_factor=a, max_depth=d)
        scene = c["scene"]
        scene["spheres"] = (scene["spheres"][:spheres] if scene["kind"] == "explicit"
                            else spheres)
        c["reference"]["block_pixels"] = 64
        (bench / "configs" / f"{name}.json").write_text(json.dumps(c))
        spec["configs"].append({"name": name, "source": "test", "reduced": [],
                                "file": f"benchmark/configs/{name}.json",
                                "why": "a CPU rehearsal"})
        cell = next(x for x in spec["workloads"] if x["name"] == base)
        spec["workloads"].append(dict(cell, name=name, config=name))
        shutil.copy(bench / "limits" / f"{base}.json", bench / "limits" / f"{name}.json")
        for m in spec["end_to_end"] + spec["per_layer"]:
            if base in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_balls_rehearsal_runs_whole(tiny_root, trace, capsys):
    from benchmark import harness

    found, res = rehearse(tiny_root, "tiny-balls", trace)
    assert harness.finish(*res) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    names = [m["name"] for m in (found["per_layer"] if trace else found["end_to_end"])]
    assert set(line["metrics"]) <= set(names)
    if not trace:
        assert set(line["metrics"]) == set(names)
    assert set(line["check"]) == set(found["limits"])
    assert torch.isfinite(torch.tensor([m["value"] for m in line["metrics"].values()])).all()


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_x4_rehearsal_over_four_gloo_ranks(tiny_root, tmp_path, trace):
    """rand256-train-x4's path at a tiny size over four gloo ranks: fit_scene
    over the mesh's pixel blocks, the reference split over the ranks and
    summed, the line printed by rank 0 with the ranks' peaks and traces."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        url = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    out = tmp_path / "line.json"
    mp.spawn(_rank, args=(4, url, str(tiny_root), "tiny-x4", trace, str(out)),
             nprocs=4)
    res = json.loads(out.read_text())
    assert res["correct"] is True, res["check"]
    assert res["device"]["count"] == 4 and res["attempted"] > 0
    want = ({"idle_pct.train", "host_ms.train", "step_host_ms.train",
             "update_ms.train"} if trace else
            {"train_mrays_per_s", "peak_gib", "setup_s"})
    assert set(res["metrics"]) == want


def _rank(rank, world, url, root, cell, trace, out):
    import time
    from pathlib import Path

    from benchmark import harness

    torch.set_num_threads(1)
    found = harness.find_cell(Path(root), cell)
    args = harness.parse(["--workload", cell, "--seed", str(2 ** 31 + 31),
                          "--seconds", "0.1", "--trace", str(trace)])
    args.init = url
    res = harness.run_rank(found, args, rank, world, torch.device("cpu"),
                           time.perf_counter())
    if rank == 0:
        Path(out).write_text(json.dumps(res[0]))
