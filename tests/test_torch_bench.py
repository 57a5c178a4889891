"""The port's bench (raytpu_torch.bench) and the timing it stands on
(render_timed, Timer), against raytpu's on the CPU.

On the CPU the bench's inner function runs at a tiny config with the host
clock only: its device-timed keys are None there, and `main()` refuses to
measure without a card.  The card's run is chip_smoke.py's phase 20 and
tests/test_torch_cuda.py.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytpu.config as jconfig
import raytpu.grad as jgrad
import raytpu.ops.geometry as jgeometry
import raytpu.render as jrender
import raytpu.scene as jscene
from raytpu.utils.profiling import Timer as JaxTimer
import raytpu_torch.config as tconfig
import raytpu_torch.ops.geometry as tgeometry
import raytpu_torch.scene as tscene
from raytpu_torch import bench
from raytpu_torch.render import render_timed
from raytpu_torch.utils.profiling import Timer
from test_torch_grad import assert_grads_match

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bench.py's keys -> the port's (None: not ported, see the bench's docstring).
BENCH_PY_KEYS = {
    "metric": "metric", "value": "value", "unit": "unit",
    "vs_baseline": "vs_baseline",
    "wall_fwd_bwd_mrays_per_s": "wall_fwd_bwd_mrays_per_s",
    "fwd_mrays_per_s": "fwd_mrays_per_s", "fwd_backend": "fwd_backend",
    "fwd_seconds": "fwd_seconds", "fwd_bwd_seconds": "fwd_bwd_seconds",
    "fwd_bwd_backend": "fwd_bwd_backend",
    "fwd_jnp_mrays_per_s": "fwd_torch_mrays_per_s",
    "golden_800x600_d5_fwd_bwd_ms": "golden_800x600_d5_fwd_bwd_ms",
    "config5_1080p_d6_N256_wavefront_s": "config5_1080p_d6_N256_wavefront_s",
    "config5_dropped_rays": "config5_dropped_rays",
    "fwd_device_ms": "fwd_device_ms",
    "fwd_device_mrays_per_s": "fwd_device_mrays_per_s",
    "est_vpu_mfu": None,
    "step_device_ms": "step_device_ms",
    "step_device_mrays_per_s": "step_device_mrays_per_s",
    "device": "device", "backend": "backend", "width": "width",
    "height": "height", "depth": "depth", "alias": "alias",
}
# Timed on the device between CUDA events: None on the CPU.
DEVICE_KEYS = ("value", "fwd_device_ms", "fwd_device_mrays_per_s",
               "step_device_ms", "step_device_mrays_per_s",
               "fwd_device_times_ms", "step_device_times_ms", "power_limit")
TINY = dict(width=16, height=12, max_depth=2, alias_factor=1)


def test_render_timed_on_a_cpu_scene_has_raytpus_stats():
    """tests/test_sharding.py:49-54's case on both packages: the port's
    stats begin with raytpu's keys in raytpu's order, and `mesh` is the
    third positional parameter on both."""
    jcfg = jconfig.RenderConfig(width=16, height=8, max_depth=1, alias_factor=1)
    tcfg = tconfig.RenderConfig(width=16, height=8, max_depth=1, alias_factor=1)
    _, want = jrender.render_timed(jscene.default_scene(), jcfg, None, 1, 2)
    img, stats = render_timed(tscene.default_scene(device="cpu"), tcfg, None, 1, 2)
    assert tuple(img.shape) == (8, 16, 3) and img.device.type == "cpu"
    assert list(stats)[:len(want)] == list(want)
    assert list(stats)[len(want):] == ["device", "ranks", "interleave"]
    assert stats["primary_rays"] == want["primary_rays"] == 16 * 8
    assert stats["traced_rays"] == want["traced_rays"]
    assert stats["mrays_per_s"] > 0 and len(stats["times"]) == 2
    assert stats["seconds"] == min(stats["times"])
    assert (stats["backend"], stats["dropped"], stats["device"]) == ("torch", 0, "cpu")


def test_timer_takes_raytpus_case():
    """tests/test_debug_utils.py:44-48 on both Timers: a section's summed
    seconds under its name.  A section handed a result, or given one in its
    box, still times by the host clock on the CPU."""
    for timer in (JaxTimer(), Timer()):
        with timer.section("a"):
            sum(range(1000))
        assert "a" in timer.summary() and timer.summary()["a"] >= 0
    t = Timer()
    x = torch.ones(4)
    with t.section("b", result=x):
        pass
    with t.section("b") as box:
        box["value"] = (x * 2, {"y": x})
    assert t.device.type == "cpu" and len(t.times()["b"]) == 2
    assert t.summary()["b"] == pytest.approx(sum(t.times()["b"]))


def test_cli_time_on_the_cpu_prints_the_stats_line():
    res = subprocess.run(
        [sys.executable, "-m", "raytpu_torch.cli", "--cpu", "--width", "16",
         "--height", "8", "--max-depth", "1", "--time"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    stats = json.loads(res.stdout.strip().splitlines()[-1])
    assert stats["primary_rays"] == 16 * 8 * 9 and stats["device"] == "cpu"
    assert "times" not in stats


def test_hit_sq_dist_matches_raytpus():
    rng = np.random.default_rng(11)
    origin = rng.uniform(-3, 3, (256, 3)).astype(np.float32)
    direction = rng.normal(size=(256, 3)).astype(np.float32)
    js = jscene.random_scene(16, seed=5)
    ts = tscene.random_scene(16, seed=5, device="cpu")
    want = jgeometry.closest_hit(jnp.asarray(origin), jnp.asarray(direction),
                                 js.spheres)
    got = tgeometry.closest_hit(torch.from_numpy(origin),
                                torch.from_numpy(direction), ts.spheres)
    assert 0 < int(np.asarray(want.found).sum()) < 256
    np.testing.assert_array_equal(got.found.numpy(), np.asarray(want.found))
    np.testing.assert_allclose(got.sq_dist.numpy(), np.asarray(want.sq_dist),
                               rtol=1e-6)


def test_nvidia_smi_line_names_the_given_card(monkeypatch):
    """On a machine of several cards the line is the given card's, found
    by its UUID, not the first card's."""
    import types

    import raytpu_torch.device as device_mod

    rows = ("GPU-aaaa-0000, NVIDIA H100 80GB HBM3, 700.00 W\n"
            "GPU-BBBB-1111, NVIDIA H100 80GB HBM3, 500.00 W\n")
    monkeypatch.setattr(device_mod.subprocess, "run", lambda *a, **k:
                        types.SimpleNamespace(returncode=0, stdout=rows, stderr=""))
    monkeypatch.setattr(device_mod.torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(uuid=f"{d}-1111"))
    assert device_mod.nvidia_smi_line("bbbb") == "NVIDIA H100 80GB HBM3, 500.00 W"
    with pytest.raises(RuntimeError, match="no card of UUID"):
        device_mod.nvidia_smi_line("cccc")


def test_bench_without_a_card_prints_the_failure_line():
    """`python -m raytpu_torch.bench` without a card: one line, no value,
    exit 1; the CPU is not measured in the card's place.  The run imports
    neither jax nor raytpu (-X importtime lists every module imported)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-X", "importtime", "-m",
                          "raytpu_torch.bench"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1, res.stdout
    line = json.loads(lines[0])
    assert line == {"metric": "Mrays/s/chip fwd+bwd 640x480 depth-4 (device step)",
                    "value": None, "unit": "Mrays/s", "vs_baseline": None,
                    "error": "no CUDA device"}
    imported = {row.rsplit("|", 1)[1].strip() for row in res.stderr.splitlines()
                if row.startswith("import time:") and "|" in row}
    assert {"torch", "raytpu_torch.render"} <= imported
    bad = sorted(m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "raytpu"))
    assert not bad, bad


def test_bench_run_on_the_cpu_has_bench_pys_keys():
    """The bench's inner function at a tiny config (config 5 shrunk to
    random_scene(8)): every key of bench.py's line under the port's name,
    each timed key with its runs, the device-timed keys None."""
    cfg = tconfig.RenderConfig(**TINY)
    line = bench.run("cpu", cfg, cfg, cfg, config5_spheres=8)
    json.dumps(line)  # one JSON line
    ported = {v for v in BENCH_PY_KEYS.values() if v is not None}
    assert ported <= line.keys() and "est_vpu_mfu" not in line
    assert "fwd_jnp_mrays_per_s" not in line
    for key in DEVICE_KEYS:
        assert line[key] is None, key
    assert line["metric"] == "Mrays/s/chip fwd+bwd 16x12 depth-2 (device step)"
    assert line["vs_baseline"] is None and line["unit"] == "Mrays/s"
    assert (line["fwd_backend"], line["fwd_bwd_backend"], line["backend"],
            line["device"]) == ("torch", "torch", "cpu", "cpu")
    assert (line["width"], line["height"], line["depth"], line["alias"]) == (16, 12, 2, 1)
    assert line["config5_dropped_rays"] == 0
    for key, n in (("fwd_times_ms", bench.REPS), ("fwd_torch_times_ms", bench.EAGER_REPS),
                   ("fwd_bwd_times_ms", bench.REPS),
                   ("golden_800x600_d5_fwd_bwd_times_ms", bench.REPS),
                   ("config5_1080p_d6_N256_wavefront_times_ms", bench.REPS)):
        assert len(line[key]) == n and min(line[key]) > 0, key
    assert line["fwd_seconds"] * 1e3 == pytest.approx(np.median(line["fwd_times_ms"]))
    assert line["fwd_bwd_seconds"] * 1e3 == pytest.approx(
        np.median(line["fwd_bwd_times_ms"]))
    assert line["wall_fwd_bwd_mrays_per_s"] == pytest.approx(
        cfg.rays_per_frame / line["fwd_bwd_seconds"] / 1e6)
    # Each timed key's kernel launches: none on the CPU, where every
    # wrapper runs its plain version.
    assert line["launches"] == {
        key: dict.fromkeys(bench.KERNELS, 0)
        for key in ("fwd", "fwd_torch", "fwd_bwd", "golden_800x600_d5_fwd_bwd",
                    "config5_1080p_d6_N256_wavefront")}


def bench_step_against_raytpu(tscene_, jscene_, cfg):
    """The step the bench times (loss_and_grad, "auto", zero target) and
    raytpu's jitted loss_and_grad on the same scene: the loss within rtol
    1e-5, the gradients leaf by leaf as tests/test_torch_grad.py holds
    them."""
    step, backend = bench.train_step(tscene_, tconfig.RenderConfig(**cfg))
    loss, grads = step()
    want, want_grads = jgrad.loss_and_grad(
        jscene_, jconfig.RenderConfig(**cfg),
        jnp.zeros((cfg["width"] * cfg["height"], 3), jnp.float32))
    assert backend == "torch"
    np.testing.assert_allclose(float(loss), float(want), rtol=1e-5)
    assert_grads_match([t.detach().numpy() for t in tscene.scene_leaves(grads)],
                       jax.tree_util.tree_leaves(want_grads))


def test_the_benchs_step_gives_raytpus_loss():
    """The bench's step on the single-sphere frame, as
    tests/test_torch_grad.py's loss test."""
    bench_step_against_raytpu(tscene.single_sphere_scene(device="cpu"),
                              jscene.single_sphere_scene(), TINY)


def test_the_benchs_step_on_the_default_scene_gives_raytpus_loss():
    """The bench's step on the scene the bench times, at 10x8 d2.  At the
    16x12 of TINY, XLA:CPU's contracted multiply-adds in jitted raytpu
    flip 2 of the 192 pixels across a shading edge (losses 1.6e-3 apart),
    while raytpu run op by op (jax.disable_jit, tens of seconds on a CPU)
    gives the port's loss within 1e-7; at 10x8 no pixel flips."""
    bench_step_against_raytpu(tscene.default_scene(device="cpu"),
                              jscene.default_scene(),
                              dict(TINY, width=10, height=8))
