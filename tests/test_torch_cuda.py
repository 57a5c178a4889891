"""The CUDA forward kernel against its plain PyTorch version, on a card.

This file imports torch and the port only, so it runs where jax is absent;
tests/conftest.py imports jax, so on such a machine run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a CUDA device every test skips.  The contract is the forward one of
tests/test_pallas.py:19-27: outliers at 1e-2*scale <= 1%, mean abs diff
< 1e-3*scale.
"""

import numpy as np
import pytest
import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import trace_cuda
from raytpu_torch.kernels.trace_cuda import render_pixels_cuda, render_pixels_torch
from raytpu_torch.render import render_single, resolve_backend
from raytpu_torch.scene import default_scene, random_scene

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
