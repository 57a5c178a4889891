"""The port's measuring tools (raytpu_torch.tools) on the CPU.

  * shard_balance's live counts against raytpu's tools/shard_balance.py
    run as it runs, in a subprocess (the Pallas interpreter on the CPU),
    per shard and level: the counts are integers, so this is the tool's
    numeric parity check.
  * Without a card and without --cpu shard_balance exits 2, and importing
    the tools loads nothing of jax, raytpu or tools/.

shard_balance's card run is chip_smoke.py's phase 22.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from raytpu_torch.tools import shard_balance

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The tools that remain; shard_balance is the one with a --cpu main.
TOOLS = ("kernel_ab", "multiprocess_demo", "path_ab", "shard_balance")
CARD_KEYS = ["device", "power_limit", "launches"]


# shard_balance at a tiny size, as both tools take it.
SHARD_ARGS = ["--width", "64", "--height", "32", "--max-depth", "3",
              "--spheres", "64", "--shards", "2"]
# The contract a count is held to: tests/test_wavefront.py:25-36 lets 0.5%
# of a frame's pixels be outliers, and a pixel whose camera direction
# rounds another way can flip a grazing branch and change the live
# children below it.  So each count may differ from raytpu's by at most
# 0.5% of the shard's camera rays.  raytpu's wavefront rounds its camera
# (kernels/wavefront.py _camera_dirs: float64 constants, rsqrt) unlike its
# dense tracer, whose rounding the port keeps (trace.camera_rays); on the
# same states the port's level gives raytpu's liveness exactly.  Measured
# (port - raytpu, shard 0 and 1, levels 1-3 of 1024 camera rays a shard):
# blocks [0, 0, 3] and [0, 0, 2] (raytpu: [250, 259, 271], [160, 168,
# 163]); interleaved [0, 0, 3] and [0, 0, 2] (raytpu: [193, 201, 204],
# [217, 226, 230]): at most 3 of 1024, 0.29%, against a bound of 5.12.
OUTLIER_SHARE = 0.005


def split_output(stdout, stderr):
    shards = {int(m.group(1)): json.loads(f"[{m.group(2)}]") for m in
              re.finditer(r"^shard (\d+): \[(.*)\]$", stderr, re.MULTILINE)}
    return [shards[s] for s in sorted(shards)], json.loads(stdout)


@pytest.fixture(scope="module")
def shard_runs():
    """Each layout through raytpu's tool (both subprocesses at once) and
    through the port's: {layout: (raytpu's, the port's)}, each (counts per
    shard, the JSON)."""
    layouts = {"blocks": [], "interleave": ["--interleave"]}
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {layout: subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tools", "shard_balance.py"),
         *SHARD_ARGS, *extra], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for layout, extra in layouts.items()}
    ours = {}
    for layout, extra in layouts.items():
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert shard_balance.main(["--cpu", *SHARD_ARGS, *extra]) == 0
        ours[layout] = split_output(out.getvalue(), err.getvalue())
    runs = {}
    for layout, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        runs[layout] = (split_output(stdout, stderr), ours[layout])
    return runs


@pytest.mark.parametrize("layout", ["blocks", "interleave"])
def test_shard_balance_counts_match_raytpus_tool(shard_runs, layout):
    (want, want_json), (got, got_json) = shard_runs[layout]
    rays = want_json["rays_per_shard"]
    assert got_json["rays_per_shard"] == rays == 64 * 32 // 2
    assert len(got) == len(want) == 2 and all(len(c) == 3 for c in got)
    assert all(c > 0 for counts in want for c in counts)
    diff = np.abs(np.array(got) - np.array(want))
    assert diff.max() <= OUTLIER_SHARE * rays, (got, want)
    # Level 1 is equal in both layouts: its stats are raytpu's exactly.
    assert [c[0] for c in got] == [c[0] for c in want]
    assert got_json["levels"]["L1"] == want_json["levels"]["L1"]
    assert list(got_json) == list(want_json) + CARD_KEYS
    assert got_json["config"] == want_json["config"]
    for level, stats in got_json["levels"].items():
        assert list(stats) == list(want_json["levels"][level])
        assert stats["max"] == max(c[int(level[1:]) - 1] for c in got)


def test_the_tools_want_a_card_and_import_no_jax():
    """Without a card and without --cpu shard_balance exits 2 before it
    builds anything; importing the tools loads nothing of jax, raytpu or
    tools/."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    assert shard_balance.main([]) == 2
    code = ("import json, sys\n"
            + "".join(f"import raytpu_torch.tools.{name}\n" for name in TOOLS)
            + "print(json.dumps(sorted(sys.modules)))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout)
    assert "raytpu_torch.tools.shard_balance" in loaded
    bad = sorted(m for m in loaded
                 if m.split(".")[0] in ("jax", "jaxlib", "raytpu", "tools", "bench"))
    assert not bad, bad
