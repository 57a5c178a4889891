"""The port's debug render (raytpu_torch.utils.debug.checked_render) and
its last two examples (fit_golden_scene, animate) against raytpu's on the
CPU, and its profiler trace (profile_trace, scoped)."""

import dataclasses
import importlib.util
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytpu.config as jconfig
import raytpu.scene as jscene
import raytpu.trace as jtrace
import raytpu.utils.debug as jdebug
from raytpu_torch.config import RenderConfig
from raytpu_torch.examples import animate, fit_golden_scene
from raytpu_torch.image import read_ppm, tone_map
from raytpu_torch.scene import LEAF_NAMES, default_scene, scene_from_leaves
from raytpu_torch.trace import render_image, render_pixels
from raytpu_torch.utils import profile_trace, scoped
from raytpu_torch.utils.debug import NonFiniteError, checked_render

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "goldens", "default_160x120_d4.ppm")
SMALL = dict(width=16, height=8, max_depth=2, alias_factor=1)


def jax_example(name):
    """examples/<name>.py of raytpu, imported from its file."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def with_nan(scene, group, leaf):
    """`scene` (either package's) with element 0 of group.leaf set to NaN."""
    g = getattr(scene, group)
    t = getattr(g, leaf)
    if isinstance(t, torch.Tensor):
        t = t.clone()
        t.view(-1)[0] = float("nan")
    else:
        t = t.at[(0,) * t.ndim].set(jnp.nan)
    return dataclasses.replace(scene, **{group: dataclasses.replace(g, **{leaf: t})})


def test_checked_render_clean_scene():
    err, img = checked_render(default_scene(device="cpu"), RenderConfig(**SMALL))
    assert err.get() is None
    err.throw()
    assert torch.equal(img, render_image(default_scene(device="cpu"), RenderConfig(**SMALL)))
    jerr, _ = jdebug.checked_render(jscene.default_scene(),
                                    jconfig.RenderConfig(**SMALL))
    assert jerr.get() is None


@pytest.mark.parametrize("group,leaf,where", [
    ("spheres", "matte", (0, "emission")),
    ("spheres", "pos", (0, "children.origin")),
    ("spheres", "ior", (0, "children.intensity")),
    ("lights", "col", (0, "emission")),
    # A NaN radius makes its sphere vanish: no level's output shows it.
    ("spheres", "radius", (None, "spheres.radius")),
])
def test_checked_render_flags_a_nan_leaf(group, leaf, where):
    """Both packages flag the NaN; the port names where it first appears."""
    err, _ = checked_render(with_nan(default_scene(device="cpu"), group, leaf),
                            RenderConfig(**SMALL))
    assert (err.level, err.field) == where
    with pytest.raises(NonFiniteError, match=where[1]):
        err.throw()
    jerr, _ = jdebug.checked_render(with_nan(jscene.default_scene(), group, leaf),
                                    jconfig.RenderConfig(**SMALL))
    assert jerr.get() is not None


def test_profile_trace_names_the_scope(tmp_path):
    """profile_trace writes a trace into its directory, and a function
    under scoped(name) appears in it by that name, its result unchanged."""
    render = scoped("oracle_frame")(render_image)
    log_dir = tmp_path / "trace"
    cfg = RenderConfig(width=8, height=6, max_depth=1, alias_factor=1)
    with profile_trace(str(log_dir)):
        img = render(default_scene(device="cpu"), cfg)
    assert render.__name__ == "render_image"
    assert torch.equal(img, render_image(default_scene(device="cpu"), cfg))
    traces = sorted(log_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    assert '"oracle_frame"' in traces[0].read_text()


def test_fit_golden_scene_matches_raytpu(capsys):
    """3 steps at alias 1 on the in-repo 160x120 d4 golden, stride 117,
    through the example; then its fit_golden and raytpu's from the example's
    start scene give the same losses (rtol 1e-4) on the stride-117 pixels
    whose forwards agree at the start (within 1e-5*scale): the few others
    flip a grazing branch between the port and jitted raytpu
    (tests/test_torch_trace.py) and would move the 165-pixel loss by ~1%."""
    res = fit_golden_scene.main(["--golden", GOLDEN, "--depth", "4", "--steps",
                                 "3", "--stride", "117", "--cpu"])
    assert "model-mismatch floor" in capsys.readouterr().out
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    cfg, gid, start = res["cfg"], res["gid"], res["scene"]
    assert (cfg.width, cfg.height, cfg.alias_factor) == (160, 120, 1)
    assert gid.shape[0] == -(-cfg.num_pixels // 117)

    jex = jax_example("fit_golden_scene")
    truth = jscene.default_scene()
    jstart = dataclasses.replace(truth, spheres=dataclasses.replace(
        truth.spheres, pos=jnp.asarray(start.spheres.pos.numpy())))
    jcfg = jconfig.RenderConfig(width=160, height=120, max_depth=4,
                                alias_factor=1)
    port = render_pixels(start, cfg, gid).numpy()
    ref = np.asarray(jtrace.render_pixels(jstart, jcfg,
                                          jnp.asarray(gid.numpy(), jnp.int32)))
    agree = np.abs(port - ref).max(axis=-1) <= 1e-5 * np.abs(ref).max()
    assert agree.mean() >= 0.95, f"{(~agree).sum()} of {agree.size} differ"
    ok = gid[torch.from_numpy(agree)]

    target, _ = fit_golden_scene.golden_target(GOLDEN, device="cpu")
    trainable = scene_from_leaves([n == "spheres.pos" for n in LEAF_NAMES])
    _, losses = fit_golden_scene.fit_golden(start, cfg, target, ok, steps=3,
                                            lr=5e-2, trainable=trainable)
    jtrain = jax.tree_util.tree_map(lambda _: False, truth)
    jtrain = dataclasses.replace(
        jtrain, spheres=dataclasses.replace(jtrain.spheres, pos=True))
    _, jlosses = jex.fit_golden(jstart, jcfg, jex.golden_target(GOLDEN),
                                jnp.asarray(ok.numpy(), jnp.int32), steps=3,
                                lr=5e-2, trainable=jtrain)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)


def test_animate_matches_raytpu_orbit(tmp_path, capsys):
    """3 frames at 32x24 through the CPU wavefront: each PPM on disk is its
    frame, frame 0's resolved options ride to the later frames, and every
    frame agrees with raytpu's render of the same orbit under the forward
    contract (tests/test_pallas.py:19-27).  raytpu renders op by op
    (jax.disable_jit): jitted, XLA:CPU contracts multiply-adds into FMAs,
    and where the orbit brings sphere 0 near another, 18 of frame 1's 768
    pixels then flip a grazing branch (2.3% off 1e-2*scale; 3 against the
    op-by-op render)."""
    frames = animate.main(["--frames", "3", "--width", "32", "--height", "24",
                           "--outdir", str(tmp_path), "--cpu"])
    out = capsys.readouterr().out
    assert out.count("dropped=0") == 3 and "wf_opts=" in out
    jex = jax_example("animate")
    jcfg = jconfig.RenderConfig(width=32, height=24, max_depth=3, alias_factor=1)
    for f, (path, img, info) in enumerate(frames):
        assert info["dropped"] == 0 and info["wf_opts"] == frames[0][2]["wf_opts"]
        got = img.numpy()
        assert (read_ppm(path) == tone_map(got)).all()
        scene = jex.orbit(jscene.default_scene(), 2 * math.pi * f / 3)
        with jax.disable_jit():
            want = np.asarray(jtrace.render_image(scene, jcfg))
        scale = max(float(np.abs(want).max()), 1e-12)
        d = np.abs(got - want)
        assert (d.max(axis=-1) > 1e-2 * scale).mean() <= 0.01
        assert d.mean() < 1e-3 * scale
