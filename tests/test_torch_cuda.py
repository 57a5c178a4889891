"""The CUDA forward and backward kernels against their plain PyTorch
versions, on a card.

This file imports torch and the port only, so it runs where jax is absent;
tests/conftest.py imports jax, so on such a machine run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a CUDA device every test skips.  The forward's contract is that of
tests/test_pallas.py:19-27: outliers at 1e-2*scale <= 1%, mean abs diff
< 1e-3*scale.  The backward's is tests/test_pallas.py:304-314 (rtol 5e-2
where |plain| > 1e-3*scale), with the cotangent zeroed on the pixels whose
forwards differ by more than 1e-5*scale (a flipped grazing branch has a
near-singular gradient).
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.grad import loss_and_grad
from raytpu_torch.kernels import trace_cuda
from raytpu_torch.kernels.trace_cuda import (grad_pixels_cuda, grad_pixels_torch,
                                             render_pixels_cuda,
                                             render_pixels_cuda_ad,
                                             render_pixels_torch)
from raytpu_torch.render import render_single, resolve_backend
from raytpu_torch.scene import (default_scene, random_scene, scene_from_leaves,
                                scene_leaves)

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda:0")


def contract(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-12)
    d = np.abs(got - want)
    assert (d.max(axis=-1) > 1e-2 * scale).mean() <= 0.01
    assert d.mean() < 1e-3 * scale


@pytest.mark.parametrize("case", ["default_d3_a3", "random32_d1", "stride"])
def test_kernel_matches_plain_version(dev, case):
    scene, cfg, sel = {
        "default_d3_a3": (default_scene(device=dev),
                          RenderConfig(width=64, height=32, max_depth=3, alias_factor=3), {}),
        "random32_d1": (random_scene(32, seed=3, device=dev),
                        RenderConfig(width=64, height=16, max_depth=1, alias_factor=1), {}),
        "stride": (default_scene(device=dev),
                   RenderConfig(width=64, height=32, max_depth=2, alias_factor=1),
                   dict(offset=5, stride=3, count=700)),
    }[case]
    before = trace_cuda.TRACE_FWD.launches
    got = render_pixels_cuda(scene, cfg, **sel)
    torch.cuda.synchronize()
    assert trace_cuda.TRACE_FWD.launches == before + 1
    contract(got, render_pixels_torch(scene, cfg, **sel))


def test_auto_backend_runs_the_kernel(dev):
    assert resolve_backend("auto", dev) == "cuda"
    cfg = RenderConfig(width=40, height=30, max_depth=2, alias_factor=2)
    before = trace_cuda.TRACE_FWD.launches
    img = render_single(default_scene(device=dev), cfg)
    assert trace_cuda.TRACE_FWD.launches == before + 1
    assert img.shape == (30, 40, 3) and img.device.type == "cuda"


def test_kernel_raises_on_what_it_does_not_take(dev):
    with pytest.raises(ValueError):
        render_pixels_cuda(default_scene(device=dev),
                           RenderConfig(max_depth=trace_cuda.MAX_DEPTH + 1))
    with pytest.raises(ValueError):
        render_pixels_cuda(random_scene(trace_cuda.MAX_SPHERES + 1, device=dev),
                           RenderConfig(width=8, height=8))


def masked_cotangent(scene, cfg, sel, seed=0):
    k = render_pixels_cuda(scene, cfg, **sel)
    p = render_pixels_torch(scene, cfg, **sel)
    bad = (k - p).abs().amax(dim=1) > 1e-5 * p.abs().max()
    assert bad.float().mean() <= 0.01
    rng = np.random.default_rng(seed)
    g = torch.tensor(rng.uniform(0.5, 1.5, tuple(p.shape)).astype(np.float32),
                     device=p.device)
    g[bad] = 0.0
    return g


@pytest.mark.parametrize("case", ["default_d3", "random32_d1", "stride"])
def test_backward_kernel_matches_plain_version(dev, case):
    scene, cfg, sel = {
        "default_d3": (default_scene(device=dev),
                       RenderConfig(width=64, height=32, max_depth=3, alias_factor=1), {}),
        "random32_d1": (random_scene(32, seed=3, device=dev),
                        RenderConfig(width=64, height=16, max_depth=1, alias_factor=1), {}),
        "stride": (default_scene(device=dev),
                   RenderConfig(width=64, height=32, max_depth=2, alias_factor=2),
                   dict(offset=5, stride=3, count=600)),
    }[case]
    g = masked_cotangent(scene, cfg, sel)
    before = trace_cuda.TRACE_BWD.launches
    got = grad_pixels_cuda(scene, cfg, g, **sel)
    torch.cuda.synchronize()
    assert trace_cuda.TRACE_BWD.launches == before + 1
    want = grad_pixels_torch(scene, cfg, g, **sel)
    for a, w in zip(scene_leaves(got), scene_leaves(want)):
        a, w = a.cpu().numpy().ravel(), w.cpu().numpy().ravel()
        assert np.isfinite(a).all()
        big = np.abs(w) > 1e-3 * max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(a[big], w[big], rtol=5e-2, atol=1e-12)


def test_autograd_runs_the_kernel_pair(dev):
    scene = default_scene(device=dev)
    cfg = RenderConfig(width=40, height=30, max_depth=2, alias_factor=2)
    fwd, bwd = trace_cuda.TRACE_FWD.launches, trace_cuda.TRACE_BWD.launches
    leaves = [t.clone().requires_grad_(True) for t in scene_leaves(scene)]
    out = render_pixels_cuda_ad(scene_from_leaves(leaves), cfg)
    torch.sum(out).backward()
    assert trace_cuda.TRACE_FWD.launches == fwd + 1
    assert trace_cuda.TRACE_BWD.launches == bwd + 1
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)
    loss, grads = loss_and_grad(scene, cfg, torch.zeros_like(out))
    assert trace_cuda.TRACE_BWD.launches == bwd + 2
    assert torch.isfinite(loss) and grads.spheres.pos.device.type == "cuda"


def test_backward_raises_on_what_it_does_not_take(dev):
    scene = default_scene(device=dev)
    cfg = RenderConfig(width=8, height=8, max_depth=1, alias_factor=1)
    g = torch.ones(cfg.num_pixels, 3, device=dev)
    with pytest.raises(ValueError):
        grad_pixels_cuda(scene, RenderConfig(width=8, height=8,
                                             max_depth=trace_cuda.MAX_DEPTH + 1), g)
    with pytest.raises(ValueError):  # its tables outgrow shared memory
        grad_pixels_cuda(random_scene(2500, device=dev), cfg, g)
    with pytest.raises(TypeError):
        grad_pixels_cuda(scene, cfg, g.double())
    with pytest.raises(ValueError):
        grad_pixels_cuda(scene, cfg, g[:-1])
    doubled = dataclasses.replace(scene, spheres=dataclasses.replace(
        scene.spheres, radius=scene.spheres.radius.double()))
    with pytest.raises(TypeError):
        grad_pixels_cuda(doubled, cfg, g)
