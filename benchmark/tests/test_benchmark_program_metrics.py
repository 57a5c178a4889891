"""The readers of the program's own spans and counters
(raytpu_torch.utils.profiling): each returns its number from a recorder
holding known spans and counters, 0.0 where the cell recorded none of
its spans, and None from a program that records neither (the parent of
the recorder)."""

from __future__ import annotations

import pytest

from benchmark.harness import load_module
from conftest import ROOT

METRICS = ROOT / "benchmark" / "metrics"
NEW = ["step_host_ms.train", "update_ms.train", "launch_ms.train",
       "frame_host_ms.frame", "k3_live_pct.large_train", "rerun_pct.large_train",
       "kernel_load_s"]

MS = 1_000_000
SPANS = {
    "fit.step": {"count": 4, "total_ns": 12 * MS, "self_ns": 1 * MS},
    "fit.readback": {"count": 4, "total_ns": 4 * MS, "self_ns": 4 * MS},
    "fit.update": {"count": 4, "total_ns": 2 * MS, "self_ns": 2 * MS},
    "k1.launch": {"count": 4, "total_ns": 3 * MS, "self_ns": 1 * MS},
    "k2.launch": {"count": 4, "total_ns": 2 * MS, "self_ns": 2 * MS},
    "scene.tables": {"count": 8, "total_ns": 1 * MS, "self_ns": 1 * MS},
    "render.frame": {"count": 5, "total_ns": 3 * MS, "self_ns": 2 * MS},
}
COUNTERS = {"wf.live": 300, "wf.slots": 1200, "fit.reruns": 1,
            "kernel.load_s": 2.5, "kernel.builds": 0, "launches.wf_level": 9}
WANT = {"step_host_ms.train": 2.0, "update_ms.train": 0.5,
        "launch_ms.train": 1.0, "frame_host_ms.frame": 0.6,
        "k3_live_pct.large_train": 25.0, "rerun_pct.large_train": 25.0,
        "kernel_load_s": 2.5}


def reader(name):
    return load_module(METRICS / f"{name}.py", f"test_metric_{name}")


@pytest.fixture
def recorder(monkeypatch):
    """The program's recorder with `fill(spans, counters)` to set what it
    returns."""
    from raytpu_torch.utils import profiling

    def fill(spans, counters):
        monkeypatch.setattr(profiling, "spans", lambda: spans)
        monkeypatch.setattr(profiling, "counters", lambda: counters)
    return fill


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_the_recorder(recorder, name):
    recorder(SPANS, COUNTERS)
    assert reader(name).read(None) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_zero_where_nothing_was_recorded(recorder, name):
    recorder({}, {"kernel.load_s": 0.0, "kernel.builds": 0})
    assert reader(name).read(None) == 0.0


@pytest.mark.parametrize("name", NEW)
def test_reader_reads_nothing_from_a_program_without_a_recorder(monkeypatch, name):
    from raytpu_torch.utils import profiling

    for fn in ("spans", "counters"):
        monkeypatch.delattr(profiling, fn)
    assert reader(name).read(None) is None


def test_the_live_share_reads_what_the_program_counted():
    """Counted through the program's own count() under a profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from raytpu_torch.utils import profiling

    profiling.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            profiling.count("wf.slots", 8192)
            profiling.count("wf.live", 4096)
            profiling.count("wf.live", torch.tensor(1024))
        assert reader("k3_live_pct.large_train").read(None) == 62.5
    finally:
        profiling.reset()
