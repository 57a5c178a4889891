"""The port's measuring tools (raytpu_torch.tools.bench_all, step_bench,
shard_balance, wf_breakdown) against raytpu's tools/*.py, on the CPU.

  * bench_all's configs are raytpu's list and scenes, leaf for leaf; the
    paths its rows take under the port's rules are raytpu's on all five;
    its rows carry raytpu's keys for their kind, plus the port's named
    additions; a row whose stage raised fails main.
  * shard_balance's live counts against raytpu's tool run as it runs, in a
    subprocess (the Pallas interpreter on the CPU), per shard and level:
    the counts are integers, so this is the tools' numeric parity check.
  * step_bench and wf_breakdown print raytpu's keys, less the TPU-only
    ones named here, plus the port's additions.
  * Without a card and without --cpu each tool exits 2, and none imports
    jax or anything of raytpu or tools/.

The tools' card runs are chip_smoke.py's phase 22 and
tests/test_torch_cuda.py.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import raytpu.config as jconfig
import raytpu.scene as jscene
import raytpu_torch.config as tconfig
import raytpu_torch.scene as tscene
from raytpu.kernels.trace_pallas import BWD_MAX_SPHERES
from raytpu_torch.tools import bench_all, shard_balance, step_bench, wf_breakdown

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = {"bench_all": bench_all, "step_bench": step_bench,
         "shard_balance": shard_balance, "wf_breakdown": wf_breakdown}

# raytpu's list, tools/bench_all.py:41-53: (name, scene builder, its
# arguments, RenderConfig's arguments).
RAYTPU_CONFIGS = [
    ("config1", "single_sphere_scene", {},
     dict(width=64, height=64, max_depth=0, alias_factor=1)),
    ("config2", "default_scene", {}, dict(width=320, height=240, max_depth=2)),
    ("config3", "default_scene", {}, dict(width=640, height=480, max_depth=4)),
    ("golden", "default_scene", {}, dict(width=800, height=600, max_depth=5)),
    ("config5", "random_scene", dict(num_spheres=256, num_lights=4),
     dict(width=1920, height=1080, max_depth=6)),
]

# The keys raytpu's tools/bench_all.py writes into a successful row: every
# row's (:56-58), the forward's (:61-62), the wavefront frame's where it
# runs (:86-90), then the wavefront step's (:109-113) or the dense step's
# (:121-122).
ROW = ["config", "width", "height", "depth", "alias", "spheres",
       "fwd_ms", "fwd_mrays_s"]
ROW_KEYS = {
    "dense": ROW + ["fwd_bwd_ms", "fwd_bwd_mrays_s"],
    "large": ROW + ["fwd_wavefront_ms", "fwd_wavefront_mrays_s",
                    "wavefront_dropped", "fwd_bwd_wavefront_dropped",
                    "fwd_bwd_wavefront_ms", "fwd_bwd_wavefront_mrays_s"],
}
# Each kind's timed keys: the port adds their runs (`*_times_ms`) and their
# launches (`launches`, by key).
TIMED = {"dense": ["fwd", "fwd_bwd"],
         "large": ["fwd", "fwd_wavefront", "fwd_bwd_wavefront"]}
# A tiny row of each kind.  The large one is past the dense kernels' depth
# bound, so that the port's rules take the wavefront for both its frame and
# its step at this size, as raytpu's rule (N >= 128, depth >= 4) does.
TINY_ROWS = {
    "dense": (lambda: tscene.default_scene(device="cpu"),
              dict(width=16, height=12, max_depth=2, alias_factor=1)),
    "large": (lambda: tscene.random_scene(128, device="cpu"),
              dict(width=4, height=3, max_depth=9, alias_factor=1)),
}

# raytpu's tools/step_bench.py:61-80 and tools/wf_breakdown.py:85-136 keys.
STEP_BENCH_KEYS = ["fwd_compile_s", "fwd_ms", "flat_step_compile_s",
                   "flat_step_ms", "packed_step_compile_s", "packed_step_ms",
                   "config", "packed_win_ms", "nonfwd_flat_ms",
                   "nonfwd_packed_ms", "packed_step_mrays_per_s_wall"]
WF_BREAKDOWN_KEYS = ["rays", "spheres", "lights", "level_spawn_ms",
                     "level_leaf_ms", "compact_2x_ms", "scatter_ms",
                     "scatter_eighth_live_ms", "scatter_window_ms", "dup_ms"]
# raytpu's keys that time TPU glue the port has not got (the docstring of
# raytpu_torch/tools/wf_breakdown.py says why).
TPU_ONLY_KEYS = {"scatter_window_ms", "dup_ms"}
CARD_KEYS = ["device", "power_limit", "launches"]


def raytpu_source(name):
    with open(os.path.join(ROOT, "tools", f"{name}.py")) as f:
        return f.read()


def test_bench_all_configs_are_raytpus():
    got = bench_all.configs(False, "cpu")
    assert [c[0] for c in got] == [c[0] for c in RAYTPU_CONFIGS]
    assert [c[0] for c in bench_all.configs(True, "cpu")] == [
        c[0] for c in RAYTPU_CONFIGS[:4]]
    for (name, scene, cfg), (_, builder, args, cfg_args) in zip(got, RAYTPU_CONFIGS):
        want = jconfig.RenderConfig(**cfg_args)
        assert (cfg.width, cfg.height, cfg.max_depth, cfg.alias_factor) == (
            want.width, want.height, want.max_depth, want.alias_factor), name
        leaves = jax.tree_util.tree_leaves(getattr(jscene, builder)(**args))
        ours = tscene.scene_leaves(scene)
        assert len(ours) == len(leaves), name
        for a, b in zip(ours, leaves):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    # Config 5's scene is seed 0's, as raytpu's: not bench.py's seed 3.
    assert not torch.equal(got[-1][1].spheres.pos,
                           tscene.random_scene(256, seed=3, device="cpu").spheres.pos)


def test_bench_all_paths_are_raytpus_on_its_configs():
    """raytpu times the wavefront where N >= 128 and depth >= 4 (its
    tools/bench_all.py:67, :95) and the dense step where N <=
    BWD_MAX_SPHERES (:118); the port's measured rules agree on all five."""
    for name, scene, cfg in bench_all.configs(False, "cpu"):
        n = scene.spheres.count
        large = n >= 128 and cfg.max_depth >= 4
        step = "wavefront" if large else ("cuda" if n <= BWD_MAX_SPHERES else None)
        assert bench_all.paths(scene, cfg) == (large, step), name


@pytest.mark.parametrize("kind", sorted(TINY_ROWS))
def test_bench_all_row_has_raytpus_keys(kind):
    make, cfg_args = TINY_ROWS[kind]
    scene, cfg = make(), tconfig.RenderConfig(**cfg_args)
    assert bench_all.paths(scene, cfg) == (
        (False, "cuda") if kind == "dense" else (True, "wavefront"))
    row = bench_all.row(kind, scene, cfg)
    adds = [f"{key}_times_ms" for key in TIMED[kind]] + ["launches"]
    assert sorted(row) == sorted(ROW_KEYS[kind] + adds)
    assert [k for k in row if k in ROW_KEYS[kind]] == ROW_KEYS[kind]
    for key in TIMED[kind]:
        runs = row[f"{key}_times_ms"]
        reps = bench_all.STEP_REPS if key == "fwd_bwd_wavefront" else bench_all.REPS
        assert len(runs) == reps and min(runs) > 0, key
        assert row[f"{key}_ms"] == round(min(runs), 2) > 0, key
    if kind == "large":
        assert row["wavefront_dropped"] == row["fwd_bwd_wavefront_dropped"] == 0
    # No kernel launches on the CPU: every wrapper runs its plain version.
    assert row["launches"] == {key: dict.fromkeys(
        ("trace_fwd", "trace_bwd", "wf_level", "wf_compact", "wf_level_bwd",
         "wf_uncompact"), 0) for key in TIMED[kind]}


def tiny_configs(skip_large, device):
    return [("tiny", tscene.single_sphere_scene(device=device),
             tconfig.RenderConfig(width=8, height=6, max_depth=0, alias_factor=1))]


def test_bench_all_main_fails_on_a_stage_that_raised(monkeypatch, capsys):
    monkeypatch.setattr(bench_all, "configs", tiny_configs)
    assert bench_all.main(["--cpu"]) == 0
    line = json.loads(capsys.readouterr().out)
    assert "fwd_ms" in line and "fwd_bwd_ms" in line
    assert (line["device"], line["power_limit"]) == ("cpu", None)

    def broken(scene, cfg):
        raise RuntimeError("trace_fwd launch failed: CUDA error 719")

    monkeypatch.setattr(bench_all, "render_image_cuda", broken)
    assert bench_all.main(["--cpu"]) == 1
    line = json.loads(capsys.readouterr().out)
    assert line["fwd_error"] == "RuntimeError: trace_fwd launch failed: CUDA error 719"
    assert "fwd_ms" not in line and "fwd_bwd_ms" in line


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


def run_main(module, argv, capsys):
    assert module.main(argv) == 0
    return json.loads(capsys.readouterr().out)


def port_keys(raytpu_keys, timed):
    return ([k for k in raytpu_keys if k not in TPU_ONLY_KEYS]
            + [f"{t}_times_ms" for t in timed] + CARD_KEYS)


def test_the_written_out_keys_are_raytpus():
    """Every literal key of raytpu's two tools is in the lists above, and
    step_bench's runs name its timed keys."""
    for name, keys in (("step_bench", STEP_BENCH_KEYS),
                       ("wf_breakdown", WF_BREAKDOWN_KEYS)):
        src = raytpu_source(name)
        literal = set(re.findall(r'out\["(\w+)"\]', src))
        assert literal and literal <= set(keys), name
    runs = re.findall(r'run\("(\w+)"', raytpu_source("step_bench"))
    assert runs == ["fwd", "flat_step", "packed_step"]
    assert {f"{r}{s}" for r in runs for s in ("_compile_s", "_ms")} <= set(
        STEP_BENCH_KEYS)


def test_step_bench_prints_raytpus_keys(capsys):
    line = run_main(step_bench, ["--cpu", "--width", "16", "--height", "12",
                                 "--max-depth", "2", "--alias-factor", "1"], capsys)
    timed = ["fwd", "flat_step", "packed_step"]
    assert sorted(line) == sorted(port_keys(STEP_BENCH_KEYS, timed))
    assert line["config"] == "16x12 d2 alias1"
    for key in timed:
        assert len(line[f"{key}_times_ms"]) == step_bench.REPS
        assert line[f"{key}_ms"] == round(min(line[f"{key}_times_ms"]), 2) > 0
    # Each of the three is rounded to 0.01 ms from the unrounded times.
    assert abs(line["packed_win_ms"]
               - (line["flat_step_ms"] - line["packed_step_ms"])) <= 0.0101
    assert set(line["launches"]) == set(timed)


def test_wf_breakdown_prints_raytpus_keys(capsys):
    line = run_main(wf_breakdown, ["--cpu", "--rays", "4096", "--spheres", "16"],
                    capsys)
    timed = ["level_spawn", "level_leaf", "compact_2x", "scatter",
             "scatter_eighth_live"]
    assert sorted(line) == sorted(port_keys(WF_BREAKDOWN_KEYS, timed))
    assert (line["rays"], line["spheres"], line["lights"]) == (4096, 16, 4)
    for key in timed:
        runs = line[f"{key}_times_ms"]
        assert len(runs) == wf_breakdown.REPS and min(runs) > 0
        assert line[f"{key}_ms"] == round(float(np.median(runs)), 2)
    assert set(line["launches"]) == set(timed)


def test_the_tools_want_a_card_and_import_no_jax():
    """Without a card and without --cpu each tool exits 2 before it builds
    anything; importing the four loads nothing of jax, raytpu or tools/."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    for name, module in TOOLS.items():
        assert module.main([]) == 2, name
    code = ("import json, sys\n"
            + "".join(f"import raytpu_torch.tools.{name}\n" for name in TOOLS)
            + "print(json.dumps(sorted(sys.modules)))")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    loaded = json.loads(res.stdout)
    assert "raytpu_torch.tools.bench_all" in loaded
    bad = sorted(m for m in loaded
                 if m.split(".")[0] in ("jax", "jaxlib", "raytpu", "tools", "bench"))
    assert not bad, bad
