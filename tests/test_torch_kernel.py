"""The fused forward kernel's wrapper and plain version.

On the CPU the wrapper runs the plain version (the eager tracer on the
kernel's pixel set); it is held against raytpu's Pallas kernel in interpret
mode under the forward contract of tests/test_pallas.py:19-27.  The CUDA
kernel itself runs only on a card: tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import raytpu.config as jconfig
import raytpu.scene as jscene
from raytpu.kernels.trace_pallas import (_scene_tables, render_image_pallas,
                                         render_pixels_pallas)
import raytpu_torch.config as tconfig
import raytpu_torch.render as trender
import raytpu_torch.scene as tscene
from raytpu_torch.kernels import trace_cuda
from raytpu_torch.kernels.trace_cuda import (render_image_cuda,
                                             render_pixels_cuda,
                                             render_pixels_torch, scene_tables)
from raytpu_torch.render import render_single, resolve_backend

torch.set_num_threads(2)


def contract(got, want, frac_tol=0.01, mean_tol=1e-3):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-12)
    d = np.abs(got - want).reshape(-1, 3)
    outliers = (d.max(axis=1) > 1e-2 * scale).mean()
    assert outliers <= frac_tol, f"outlier fraction {outliers}"
    assert d.mean() < mean_tol * scale, f"mean abs diff {d.mean()} vs {scale}"


# Interpret mode is slow: toy shapes only.
@pytest.mark.parametrize("width,height,depth", [(64, 32, 2), (50, 17, 1)])
def test_plain_version_matches_pallas_interpret(width, height, depth):
    kw = dict(width=width, height=height, max_depth=depth, alias_factor=1)
    want = render_image_pallas(jscene.default_scene(), jconfig.RenderConfig(**kw),
                               interpret=True)
    got = render_image_cuda(tscene.default_scene(device="cpu"), tconfig.RenderConfig(**kw))
    assert got.shape == (height, width, 3)
    contract(got, want)


def test_offset_stride_count_interface():
    kw = dict(width=64, height=32, max_depth=1, alias_factor=1)
    sel = dict(offset=5, stride=3, count=700)  # runs past P: the tail clamps
    want = render_pixels_pallas(jscene.default_scene(), jconfig.RenderConfig(**kw),
                                interpret=True, **sel)
    got = render_pixels_cuda(tscene.default_scene(device="cpu"),
                             tconfig.RenderConfig(**kw), **sel)
    assert got.shape == (700, 3)
    contract(got, want)
    torch.testing.assert_close(got[-1], got[-2], rtol=0, atol=0)  # both P-1


def test_wrapper_on_cpu_is_the_plain_version():
    scene = tscene.random_scene(8, seed=1, device="cpu")
    cfg = tconfig.RenderConfig(width=24, height=10, max_depth=2, alias_factor=2)
    before = trace_cuda.TRACE_FWD.launches
    got = render_pixels_cuda(scene, cfg, offset=3, stride=2, count=50)
    assert trace_cuda.TRACE_FWD.launches == before  # no kernel on the CPU
    torch.testing.assert_close(
        got, render_pixels_torch(scene, cfg, offset=3, stride=2, count=50),
        rtol=0, atol=0)
    assert render_pixels_cuda(scene, cfg, count=0).shape == (0, 3)


def test_scene_tables_match_the_tpu_kernel_layout():
    j = [np.asarray(x) for x in _scene_tables(jscene.random_scene(5, seed=2))]
    s, l, b = scene_tables(tscene.random_scene(5, seed=2, device="cpu"))
    np.testing.assert_array_equal(s.numpy(), j[0])
    np.testing.assert_array_equal(l.numpy(), j[1])
    np.testing.assert_array_equal(b.numpy(), j[2].reshape(5))
    assert s.is_contiguous() and l.is_contiguous() and b.is_contiguous()


def test_pixel_set_is_validated():
    scene = tscene.default_scene(device="cpu")
    cfg = tconfig.RenderConfig(width=8, height=4, max_depth=0, alias_factor=1)
    for bad in (dict(offset=-1), dict(stride=0), dict(count=-2)):
        with pytest.raises(ValueError):
            render_pixels_cuda(scene, cfg, **bad)


def test_scene_checks_before_launch():
    scene = tscene.default_scene(device="cpu")
    trace_cuda._check_scene(scene, scene.device)
    with pytest.raises(TypeError):
        trace_cuda._check_scene(_with(scene, radius=scene.spheres.radius.double()),
                                scene.device)
    with pytest.raises(ValueError):
        trace_cuda._check_scene(_with(scene, pos=scene.spheres.pos[:, :2]),
                                scene.device)
    with pytest.raises(ValueError):
        trace_cuda._check_scene(scene, torch.device("meta"))


def _with(scene, **spheres):
    return dataclasses.replace(
        scene, spheres=dataclasses.replace(scene.spheres, **spheres))


@dataclasses.dataclass
class _OnCard:
    """A CPU scene's counts reporting a CUDA device: all that the routing
    reads of a scene (the device is only inspected, not used)."""

    spheres: object
    lights: object
    device: torch.device = torch.device("cuda")


def test_backend_resolution():
    assert resolve_backend("auto", device="cpu") == "torch"
    assert resolve_backend("torch", device="cpu") == "torch"
    with pytest.raises(ValueError):
        resolve_backend("cuda", device="cpu")
    with pytest.raises(ValueError):
        resolve_backend("pallas", device="cpu")
    assert resolve_backend("wavefront", device="cpu") == "wavefront"
    # "auto" on a card: the dense kernel unless the scene and config pass
    # the measured crossover; the cells measured at its two ends stay on
    # their sides.  A scene's own device wins over `device`.
    deep = tconfig.RenderConfig(width=8, height=8, max_depth=6, alias_factor=1)
    big = tscene.random_scene(256, seed=3, device="cpu")
    on_card = lambda s: _OnCard(s.spheres, s.lights)  # noqa: E731
    assert resolve_backend("auto", device="cuda") == "cuda"
    assert resolve_backend("auto", on_card(big), deep) == "wavefront"
    assert resolve_backend("auto", on_card(tscene.default_scene(device="cpu")),
                           deep) == "cuda"
    for n, depth in ((16, 6), (64, 2), (64, 4), (128, 2)):
        cfg = tconfig.RenderConfig(width=8, height=8, max_depth=depth)
        scene = tscene.random_scene(n, device="cpu")
        want = trender.card_backend(scene, cfg)
        assert resolve_backend("auto", on_card(scene), cfg) == want
    assert resolve_backend("auto", big, deep) == "torch"
    assert resolve_backend("auto", big, deep, device="cuda") == "torch"
    scene = tscene.single_sphere_scene(device="cpu")
    cfg = tconfig.RenderConfig(width=8, height=4, max_depth=0, alias_factor=1)
    with pytest.raises(ValueError):
        render_single(scene, cfg, backend="cuda")
    assert render_single(scene, cfg).shape == (4, 8, 3)

