"""Nothing the benchmark runs imports JAX or the JAX package raytpu, and
the reference imports neither of them nor the program; module names are
compared by their whole top-level name (raytpu_torch is not raytpu)."""

from __future__ import annotations

import ast
import json
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from conftest import ROOT

BENCH = ROOT / "benchmark"
JAX_SIDE = {"jax", "jaxlib", "flax", "raytpu"}


def imported_top_levels(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(*parts):
    return [p for p in BENCH.glob("**/*.py") if "tests" not in p.relative_to(BENCH).parts
            and (not parts or p.relative_to(BENCH).parts[0] in parts)]


def test_reference_imports_neither_jax_nor_the_program():
    for path in sources("reference"):
        found = imported_top_levels(path) & (JAX_SIDE | {"raytpu_torch"})
        assert not found, f"{path} imports {found}"


def test_no_benchmark_module_imports_jax():
    assert sources()
    for path in sources():
        found = imported_top_levels(path) & JAX_SIDE
        assert not found, f"{path} imports {found}"


def test_whole_names_are_compared():
    from benchmark.harness import FORBIDDEN

    assert "raytpu_torch" not in FORBIDDEN and "raytpu" in FORBIDDEN


def test_a_run_loads_no_jax_module(tiny_root):
    """A rehearsal of every tiny cell in a fresh process: sys.modules holds
    no JAX-side module by whole top-level name when the line is printed."""
    code = (
        "import sys, time, torch\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from pathlib import Path\n"
        "from benchmark import harness\n"
        "for cell in ('tiny-train', 'tiny-frame'):\n"
        f"    found = harness.find_cell(Path({str(tiny_root)!r}), cell)\n"
        "    args = harness.parse(['--workload', cell, '--seed', '3', '--seconds', '0.2'])\n"
        "    res = harness.run_rank(found, args, 0, 1, torch.device('cpu'), time.perf_counter())\n"
        "    assert harness.finish(*res) == 0\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "raytpu_torch" in loaded
    assert not loaded & JAX_SIDE


def _launched_rank(rank, world, url, root, planted, out):
    """Rank 0 runs as the launching process does; rank 1 as a rank the
    launcher started, with `planted` loaded under the port."""
    import time
    import types

    import torch

    from benchmark import harness

    cell = "tiny-sharded"
    found = harness.find_cell(Path(root), cell)
    args = harness.parse(["--workload", cell, "--seed", str(2 ** 31 + 31),
                          "--seconds", "0.1", "--rank", str(rank),
                          "--world", str(world), "--init", url])
    if rank == 0:
        harness.run_rank(found, args, 0, world, torch.device("cpu"),
                         time.perf_counter())
        return
    if planted:
        sys.modules[planted] = types.ModuleType(planted)
    code = harness.rank_main(found, args, torch.device("cpu"), time.perf_counter())
    Path(out).write_text(json.dumps(code))


@pytest.mark.parametrize("planted", [None, "jax", "raytpu.tracer"])
def test_a_launched_rank_refuses_a_forbidden_module(tiny_root, tmp_path, planted):
    """A rank the launcher started checks its own sys.modules once the
    window has closed: it exits non-zero when it holds a JAX-side module
    (and the launching process then prints no line), and 0 when not."""
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        url = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    out = tmp_path / "code.json"
    mp.spawn(_launched_rank, args=(2, url, str(tiny_root), planted, str(out)),
             nprocs=2)
    assert json.loads(out.read_text()) == (3 if planted else 0)
