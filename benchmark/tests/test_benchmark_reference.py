"""The reference agrees with the port's eager tracer and its autograd
gradient at tiny sizes, and the benchmark's scene recipes give the port's
scenes bit for bit.  (The test imports the port; the reference does not.)"""

from __future__ import annotations

import json

import pytest
import torch

from conftest import ROOT

from benchmark import inputs
from benchmark.reference import tracer


def port_scene(kind):
    import raytpu_torch as rt

    return (rt.default_scene(device="cpu") if kind == "gamma"
            else rt.random_scene(24, seed=2 ** 31 + 3, device="cpu"))


def sizes(w, h, a, d):
    return dict(width=w, height=h, alias_factor=a, max_depth=d, zoom=-4.0,
                image_world_width=16.0, image_world_height=12.0)


@pytest.mark.parametrize("kind", ["gamma", "random"])
def test_forward_and_gradient_agree_with_the_port(kind):
    from raytpu_torch.config import RenderConfig
    from raytpu_torch.grad import loss_and_grad
    from raytpu_torch.scene import LEAF_NAMES, scene_leaves
    from raytpu_torch.trace import render_image

    scene = port_scene(kind)
    cfg = sizes(28, 18, 2, 4)
    leaves = dict(zip(LEAF_NAMES, scene_leaves(scene)))
    assert tuple(LEAF_NAMES) == tracer.LEAF_NAMES
    port = render_image(scene, RenderConfig(**cfg)).reshape(-1, 3)
    ref = tracer.render(leaves, cfg, block_pixels=100)
    scale = float(port.abs().max())
    assert float((port - ref).abs().max()) <= 1e-5 * scale
    target = 2 * float(port.mean()) * torch.rand(
        port.shape, generator=torch.Generator().manual_seed(4))
    loss, grads = loss_and_grad(scene, RenderConfig(**cfg), target, backend="torch")
    rloss, rgrads = tracer.loss_and_grad(leaves, cfg, target, block_pixels=150)
    assert abs(float(loss) - float(rloss)) <= 1e-5 * float(rloss)
    for name, g in zip(LEAF_NAMES, scene_leaves(grads)):
        r = rgrads[name]
        assert float((g - r).abs().max()) <= 1e-5 * max(float(r.abs().max()), 1e-30), name


def test_blocks_and_shares_add_up():
    """The loss and gradient over two pixel ranges add up to the whole
    frame's, and render's blocks make one frame."""
    scene = dict(zip(tracer.LEAF_NAMES,
                     inputs.scene_leaves(json.loads(
                         (ROOT / "benchmark/configs/gamma-800x600-d5.json").read_text()),
                         0, "cpu").values()))
    cfg = sizes(16, 10, 1, 3)
    target = 1e-5 * torch.rand(160, 3, generator=torch.Generator().manual_seed(1))
    whole, g = tracer.loss_and_grad(scene, cfg, target, block_pixels=160)
    a, ga = tracer.loss_and_grad(scene, cfg, target, block_pixels=33, pixels=(0, 70))
    b, gb = tracer.loss_and_grad(scene, cfg, target, block_pixels=33, pixels=(70, 90))
    assert abs(float(a + b) - float(whole)) <= 1e-6 * float(whole)
    for k in g:
        assert torch.allclose(ga[k] + gb[k], g[k], rtol=1e-5, atol=1e-12)
    assert torch.equal(tracer.render(scene, cfg, 160), tracer.render(scene, cfg, 7))


@pytest.mark.parametrize("config, port", [
    ("gamma-800x600-d5", lambda s: __import__("raytpu_torch").default_scene(device="cpu")),
    ("rand256-1080p-d6", lambda s: __import__("raytpu_torch").random_scene(
        256, num_lights=4, seed=s, device="cpu"))])
def test_scene_recipes_are_the_ports_scenes(config, port):
    from raytpu_torch.scene import scene_leaves

    c = json.loads((ROOT / "benchmark" / "configs" / f"{config}.json").read_text())
    fixed = c["scene"].pop("seed", None)
    for seed in (0, 3, 2 ** 31 + 17):
        ours = inputs.scene_leaves(c, seed, "cpu")
        assert all(torch.equal(a, b) for a, b in zip(ours.values(),
                                                      scene_leaves(port(seed))))
    if fixed is not None:  # the configuration's own scene, whatever the run's seed
        c["scene"]["seed"] = fixed
        ours = inputs.scene_leaves(c, 2 ** 31 + 17, "cpu")
        assert all(torch.equal(a, b) for a, b in zip(ours.values(),
                                                      scene_leaves(port(fixed))))
