"""The port's command line against raytpu's, and its freedom from JAX."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import raytpu.cli as jcli
import raytpu_torch.cli as tcli
from raytpu_torch.image import read_ppm

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--width", "32", "--height", "24", "--max-depth", "2", "--alias-factor", "1",
         "--cpu"]


def test_render_matches_raytpu_cli(tmp_path, capsys):
    """The same command line through both CLIs: tone-mapped PPMs agree
    under the forward contract (outliers at 1e-2*255 <= 1%, mean abs diff
    < 1e-3*255), and --compare reports the same stats as raytpu's."""
    a, b = str(tmp_path / "torch.ppm"), str(tmp_path / "jax.ppm")
    assert tcli.main(SMALL + ["-o", a]) == 0
    assert jcli.main(SMALL + ["-o", b]) == 0
    got, want = read_ppm(a).astype(np.float64), read_ppm(b).astype(np.float64)
    assert got.shape == want.shape == (24, 32, 3)
    d = np.abs(got - want)
    assert (d.max(axis=-1) > 1e-2 * 255).mean() <= 0.01
    assert d.mean() < 1e-3 * 255

    capsys.readouterr()
    assert tcli.main(["--compare", a, b]) == 0
    stats = json.loads(capsys.readouterr().out)
    assert stats == jcli.compare_ppms(a, b)
    assert stats["shape"] == [24, 32, 3]


def test_compare_size_mismatch(tmp_path, capsys):
    a, b = str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm")
    assert tcli.main(["--width", "8", "--height", "4", "--max-depth", "0",
                      "--alias-factor", "1", "--cpu", "-o", a]) == 0
    assert tcli.main(["--width", "4", "--height", "4", "--max-depth", "0",
                      "--alias-factor", "1", "--cpu", "-o", b]) == 0
    capsys.readouterr()
    assert tcli.main(["--compare", a, b]) == 2
    assert "error" in json.loads(capsys.readouterr().out)


def test_scene_file_round_trip_and_flags(tmp_path, capsys):
    scene_json = str(tmp_path / "s.json")
    a, b = str(tmp_path / "a.ppm"), str(tmp_path / "b.ppm")
    base = ["--width", "16", "--height", "8", "--max-depth", "1",
            "--alias-factor", "1", "--cpu"]
    assert tcli.main(base + ["--scene", "random", "--num-spheres", "6",
                             "--seed", "3", "--bg-opacity", "0.5",
                             "--save-scene", scene_json, "-o", a]) == 0
    with open(scene_json) as f:
        assert json.load(f)["background"]["opacity"] == 0.5
    assert tcli.main(base + ["--scene-file", scene_json, "-o", b]) == 0
    np.testing.assert_array_equal(read_ppm(a), read_ppm(b))
    assert tcli.main(base + ["--scene", "single", "--backend", "torch", "-o", a]) == 0
    capsys.readouterr()
    assert tcli.main(["--list-devices"]) == 0
    assert capsys.readouterr().out.splitlines()[0] == "cpu"


@pytest.mark.parametrize("flags", [
    ["--sharded"], ["--interleave"], ["--oracle"], ["--strict-drops"],
    ["--chunk-rays", "1024"], ["--capacity-factor", "2.0"], ["--streams", "2"],
])
def test_unported_flags_name_the_roadmap(flags, capsys):
    assert tcli.main(flags) == 2
    assert "ROADMAP" in capsys.readouterr().err


def test_time_and_cuda_backend_need_a_card(capsys):
    """--time and --backend cuda need a CUDA scene; without --cpu and
    without a card the CLI exits 2 rather than render on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    assert tcli.main(SMALL + ["--time"]) == 2
    assert "CUDA" in capsys.readouterr().err
    with pytest.raises(ValueError):
        tcli.main(SMALL + ["--backend", "cuda"])
    no_cpu = [a for a in SMALL if a != "--cpu"]
    assert tcli.main(no_cpu + ["-o", "unused.ppm"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_port_never_imports_jax():
    code = ("import sys, raytpu_torch, raytpu_torch.cli, raytpu_torch.kernels, "
            "raytpu_torch.render, raytpu_torch.grad, raytpu_torch.utils, "
            "raytpu_torch.examples.fit_scene; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'raytpu')); "
            "print(bad); sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
