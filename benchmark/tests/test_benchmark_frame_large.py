"""The config-5 frame cell (rand256-frame): its files are found by name,
its four readers read what the program traced and counted (and nothing
from a program without counters or a run without its kernels), and a CPU
rehearsal at a tiny size runs whole, is correct, and fails under the
control and with its frame altered where it is produced."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from conftest import ROOT
from test_benchmark_rehearsal import rehearse

from benchmark import compare, control
from benchmark.harness import find_cell, load_module

CELL = "rand256-frame"
READERS = ["idle_pct.large_frame", "k3_ms.large_frame", "k5_ms.large_frame",
           "k3_live_pct.large_frame"]


def test_the_cell_is_found_by_name():
    found = find_cell(ROOT, CELL)
    assert found["cell"]["chips"] == 1
    assert found["config"]["name"] == "rand256-1080p-d6"
    assert found["cell"]["traffic"] == "frame-large"
    assert found["traffic"] == {
        "loop": "frame", "why": found["traffic"]["why"], "variants": 4,
        "jitter": {"spheres.pos": 0.5, "lights.pos": 5.0}, "warmup": 1,
        "keep_within": 64, "off_threshold": 0.01, "trace_iterations": 10}
    assert set(found["limits"]) == {"off_share", "mean_abs_rel"}
    # Its own rate and bound, and no iter_ms_p95: that metric's bound
    # (0.25) is over eight times this card-paced cell's spread.
    assert [m["name"] for m in found["end_to_end"]] == [
        "peak_gib", "setup_s", "large_frame_mrays_per_s"]
    assert {m["name"] for m in found["per_layer"]} == set(READERS) | {"kernel_load_s"}
    for m in found["per_layer"]:
        if m["name"] in READERS:
            assert m["moves"] == "large_frame_mrays_per_s"
            assert m["workloads"] == [CELL]


def reader(name):
    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                       f"test_metric_{name}")


def _view(kernel_ns_by_rank, steps=10, busy_ns=0, window_ns=1):
    from benchmark.trace import TraceView

    return TraceView([{"kernel_ns": k, "steps": steps, "busy_ns": busy_ns,
                       "window_ns": window_ns} for k in kernel_ns_by_rank], {})


K3 = "void (anonymous namespace)::wf_level_kernel<1>(float const*, int)"
K5 = "(anonymous namespace)::wf_compact_kernel(float const*, long long, int)"
TAIL = "(anonymous namespace)::wf_tail_kernel(long long const*, long long)"


@pytest.mark.parametrize("name, want", [("k3_ms.large_frame", 63.0),
                                        ("k5_ms.large_frame", 5.5)])
def test_the_kernel_readers_read_by_kernel_name(name, want):
    """K3's time a frame, and K5's with its tail; nothing where none ran."""
    ranks = [{K3: 630_000_000, K5: 45_000_000, TAIL: 10_000_000,
              "void at::native::indexFuncLargeIndex<float>": 42_000_000}]
    assert reader(name).read(_view(ranks)) == pytest.approx(want)
    assert reader(name).read(_view([{"void at::native::other": 7}])) is None
    assert reader(name).read(_view([{}])) is None


def test_the_idle_share_reads_the_window():
    assert reader("idle_pct.large_frame").read(
        _view([{}], busy_ns=930, window_ns=1000)) == pytest.approx(7.0)


@pytest.mark.parametrize("counters, want", [
    ({"wf.slots": 400, "wf.live": 268}, 67.0),
    ({"wf.slots": 400}, 0.0),
    # No K3 slot launched (a frame of the dense kernel): nothing to read.
    ({"wf.live": 3}, None),
    ({}, None)])
def test_the_live_share_reads_the_recorder(monkeypatch, counters, want):
    from raytpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "counters", lambda: counters)
    assert reader("k3_live_pct.large_frame").read(None) == want


def test_the_live_share_reads_nothing_without_a_recorder(monkeypatch):
    from raytpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "counters")
    assert reader("k3_live_pct.large_frame").read(None) is None


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A copy of the benchmark with tiny-rand-frame: rand256-frame over 12
    spheres at 20x12, alias 1, depth 3."""
    root = tmp_path_factory.mktemp("frame_large")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    c = json.loads((bench / "configs" / "rand256-1080p-d6.json").read_text())
    c["render"].update(width=20, height=12, alias_factor=1, max_depth=3)
    c["scene"]["spheres"] = 12
    c["reference"]["block_pixels"] = 64
    (bench / "configs" / "tiny-rand-frame.json").write_text(json.dumps(c))
    spec["configs"].append({"name": "tiny-rand-frame", "source": "test", "reduced": [],
                            "file": "benchmark/configs/tiny-rand-frame.json",
                            "why": "a CPU rehearsal"})
    cell = next(x for x in spec["workloads"] if x["name"] == CELL)
    spec["workloads"].append(dict(cell, name="tiny-rand-frame", config="tiny-rand-frame"))
    shutil.copy(bench / "limits" / f"{CELL}.json", bench / "limits" / "tiny-rand-frame.json")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-rand-frame")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_rehearsal_runs_whole(tiny_root, trace, capsys):
    from benchmark import harness

    found, res = rehearse(tiny_root, "tiny-rand-frame", trace)
    assert harness.finish(*res) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    names = [m["name"] for m in (found["per_layer"] if trace else found["end_to_end"])]
    assert set(line["metrics"]) <= set(names)
    if trace:
        # The CPU renders through the plain tracer: no K3, K5 or slots.
        assert "idle_pct.large_frame" in line["metrics"]
        assert not {"k3_ms.large_frame", "k5_ms.large_frame",
                    "k3_live_pct.large_frame"} & set(line["metrics"])
    else:
        assert set(line["metrics"]) == set(names)
    assert set(line["check"]) == set(found["limits"])
    assert torch.isfinite(torch.tensor([m["value"] for m in line["metrics"].values()])).all()


def test_the_control_fails(tiny_root):
    found = find_cell(tiny_root, "tiny-rand-frame")
    got = control.frame(found, 2 ** 31 + 21, torch.device("cpu"), variants=("control",))
    assert not compare.judge(got["control"], found["limits"]), got


def test_an_altered_frame_fails(tiny_root, monkeypatch):
    """The frame's middle row is altered where the frame is produced, as
    control.py's "altered" alters the reference's."""
    import raytpu_torch.render as render

    real = render.render_single

    def altered(scene, cfg, *args, **kw):
        img = real(scene, cfg, *args, **kw).clone()
        img[img.shape[0] // 2] += 0.1 * img.abs().max()
        return img

    monkeypatch.setattr(render, "render_single", altered)
    _, (res, _) = rehearse(tiny_root, "tiny-rand-frame", seed=2 ** 31 + 23, seconds=0.1)
    assert res["correct"] is False, res["check"]
