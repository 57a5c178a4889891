"""The CUDA kernels (dense forward and backward, the wavefront's level and
compaction) against their plain PyTorch versions, on a card.

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
import json

import numpy as np
import pytest
import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.grad import loss_and_grad
from raytpu_torch.kernels import trace_cuda, wavefront
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


def _level_states(scene, dev):
    """Camera rays of a 64x32 frame at alias 2 and their first compacted
    level, for the wavefront kernels."""
    cfg = RenderConfig(width=64, height=32, max_depth=2, alias_factor=2)
    chunk, ws, cap, n = wavefront.wavefront_sizes(cfg, 4096, 2)
    return cfg, ws, cap, wavefront.chunk_camera_state(cfg, chunk, n, 0,
                                                     cfg.num_pixels, device=dev)


@pytest.mark.parametrize("name", ["default", "random32"])
def test_wavefront_kernels_match_plain_versions(dev, name):
    scene = (default_scene(device=dev) if name == "default"
             else random_scene(32, seed=3, device=dev))
    _, ws, cap, (state, pid) = _level_states(scene, dev)
    for _ in range(2):
        before = wavefront.WF_LEVEL.launches
        em, kids = wavefront.wf_level(scene, state, True)
        torch.cuda.synchronize()
        assert wavefront.WF_LEVEL.launches == before + 1
        pem, pkids = wavefront.wf_level_torch(scene, state, True)
        contract(em.T, pem.T)
        off = ~torch.isclose(kids, pkids, rtol=1e-5, atol=1e-6).all(dim=0)
        assert off.float().mean() <= 0.01
        for keep in (min(2 * state.shape[1], cap), 100):
            before = wavefront.WF_COMPACT.launches
            got = wavefront.compact(kids, pid, keep, ws)
            torch.cuda.synchronize()
            assert wavefront.WF_COMPACT.launches == before + 2
            want = wavefront.compact_torch(kids, pid, keep, ws)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        state, pid = wavefront.compact(kids, pid, min(2 * state.shape[1], cap), ws)[:2]


def test_wavefront_kernels_raise_on_what_they_do_not_take(dev):
    scene = default_scene(device=dev)
    cfg, ws, cap, (state, pid) = _level_states(scene, dev)
    with pytest.raises(ValueError):   # state on the CPU, scene on the card
        wavefront.wf_level(scene, state.cpu(), True)
    with pytest.raises(TypeError):
        wavefront.wf_level(scene, state.double(), True)
    _, kids = wavefront.wf_level(scene, state, True)
    with pytest.raises(TypeError):    # pids on the CPU, children on the card
        wavefront.compact(kids, pid.cpu(), cap, ws)
    with pytest.raises(ValueError):
        wavefront.render_pixels_wavefront(
            scene, RenderConfig(width=8, height=8, max_depth=trace_cuda.MAX_DEPTH + 1))


def test_render_single_wavefront_launches_both_kernels(dev):
    scene = default_scene(device=dev)
    cfg = RenderConfig(width=64, height=48, max_depth=3, alias_factor=2)
    l3, l5 = wavefront.WF_LEVEL.launches, wavefront.WF_COMPACT.launches
    img, info = render_single(scene, cfg, backend="wavefront",
                              wf_opts=dict(chunk_rays=4096, capacity_factor=2),
                              return_info=True)
    chunks = wavefront.wavefront_sizes(cfg, 4096, 2)[3]
    assert wavefront.WF_LEVEL.launches == l3 + chunks * 4
    assert wavefront.WF_COMPACT.launches == l5 + chunks * 3 * 2
    assert info["dropped"] == 0 and img.device.type == "cuda"
    dense = render_pixels_cuda(scene, cfg).reshape(48, 64, 3).cpu().numpy()
    got = img.cpu().numpy()
    scale = float(np.abs(dense).max())
    d = np.abs(got - dense)
    assert (d.max(axis=-1) > 1e-3 * scale).mean() <= 0.005
    assert d.mean() < 1e-4 * scale


def test_cli_time_json_has_dropped(dev, capsys):
    from raytpu_torch import cli

    assert cli.main(["--width", "64", "--height", "48", "--max-depth", "2",
                     "--alias-factor", "1", "--backend", "wavefront",
                     "--time"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["dropped"] == 0 and stats["backend"] == "wavefront"
