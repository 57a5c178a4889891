"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
tiny cells beside the real ones, and the card check of the `cuda` tests."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Tiny cells: (name, base cell, base configuration, render sizes, spheres,
# chips); tiny-sharded runs the fit loop over two ranks.
TINY = [("tiny-train", "gamma-train", "gamma-800x600-d5", (20, 12, 2, 3), None, 1),
        ("tiny-frame", "gamma-frame", "gamma-800x600-d5", (20, 12, 2, 3), None, 1),
        ("tiny-wavefront", "rand256-train", "rand256-1080p-d6", (20, 12, 1, 3), 12, 1),
        ("tiny-sharded", "rand256-train", "rand256-1080p-d6", (20, 12, 1, 3), 12, 2)]


def add_tiny_cells(root: Path):
    """Add the TINY cells to the benchmark at `root` as files and entries,
    each with its base cell's traffic, limits and metrics."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    bench = root / "benchmark"
    for name, base, config, (w, h, a, d), spheres, chips in TINY:
        c = json.loads((bench / "configs" / f"{config}.json").read_text())
        c["render"].update(width=w, height=h, alias_factor=a, max_depth=d)
        if spheres:
            c["scene"]["spheres"] = spheres
        c["reference"]["block_pixels"] = 64
        (bench / "configs" / f"{name}.json").write_text(json.dumps(c))
        spec["configs"].append({"name": name, "source": "test", "reduced": [],
                                "file": f"benchmark/configs/{name}.json",
                                "why": "a CPU rehearsal"})
        cell = next(x for x in spec["workloads"] if x["name"] == base)
        spec["workloads"].append(dict(cell, name=name, config=name, chips=chips))
        shutil.copy(bench / "limits" / f"{base}.json", bench / "limits" / f"{name}.json")
        for m in spec["end_to_end"] + spec["per_layer"]:
            if base in m.get("workloads", []):
                m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of BENCHMARK.json and benchmark/ with the TINY cells."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny_cells(root)
    return root


@pytest.fixture
def card():
    """The card the `cuda` tests run on; they skip without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
