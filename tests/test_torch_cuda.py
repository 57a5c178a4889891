"""The CUDA kernels (dense forward and backward, the wavefront's level and
compaction and their backwards) against their plain PyTorch versions, on a
card, and the paths that launch them.

This file imports torch and the port only, so it runs where jax is absent;
tests/conftest.py imports jax, so on such a machine run it as

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Without a CUDA device every test skips.  The forward's contract is that of
tests/test_pallas.py:19-27: outliers at 1e-2*scale <= 1%, mean abs diff
< 1e-3*scale.  The backward's is tests/test_pallas.py:304-314 (rtol 5e-2
where |plain| > 1e-3*scale), with the cotangent zeroed on the pixels whose
forwards differ by more than 1e-5*scale (a flipped grazing branch has a
near-singular gradient).  The wavefront's level backward is held per ray
and per table under the same contract; its compaction transpose bit for
bit; its whole gradient against the kernel pair's under
tests/test_wavefront.py:196-219's (every leaf within 2e-3*scale).  The
level kernel through its BVH and the level backward from the saved
selections are held to their brute-force reference instances bit for bit
(the backward's atomically summed tables within 1e-5 x scale).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from raytpu_torch.config import BENCH_CONFIGS, RenderConfig
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


def masked_level_cotangents(scene, state, spawn, seed):
    """Seeded cotangents of one level's emissions, U(0.5, 1.5), and
    children, U(-1, 1) with a zero medium-index row, both zeroed on the
    rays whose forwards (K3 against its plain version: emissions at
    1e-5*scale, children at rtol 1e-5) differ; returns (em_ct, ch_ct,
    the rays kept, K3's selections)."""
    em, kids, sel = wavefront.wf_level(scene, state, spawn, return_sel=True)
    pem, pkids = wavefront.wf_level_torch(scene, state, spawn)
    bad = (em - pem).abs().amax(dim=0) > 1e-5 * pem.abs().max()
    if spawn:
        off = ~torch.isclose(kids, pkids, rtol=1e-5, atol=1e-6).all(dim=0)
        bad |= off.reshape(-1, 2).any(dim=1)
    assert bad.float().mean() <= 0.01
    rng = np.random.default_rng(seed)
    rays = state.shape[1]
    em_ct = torch.tensor(rng.uniform(0.5, 1.5, (3, rays)).astype(np.float32),
                         device=state.device)
    em_ct[:, bad] = 0.0
    ch_ct = None
    if spawn:
        ch_ct = torch.tensor(rng.uniform(-1, 1, (10, 2 * rays)).astype(np.float32),
                             device=state.device)
        ch_ct[9] = 0.0
        ch_ct[:, bad.repeat_interleave(2)] = 0.0
    return em_ct, ch_ct, ~bad, sel


def assert_level_grads(got, want, keep, state):
    """K4 against its plain version: d_state on the kept rays and every
    table under the gradient contract (rtol 5e-2 where |plain| >
    1e-3*scale), exact zeros on dead rays and in the index row."""
    dead = (state[6:9] == 0).all(dim=0)
    assert bool((got[0][:, dead] == 0).all()) and bool((got[0][9] == 0).all())
    for a, w in zip((got[0][:, keep], *got[1:]), (want[0][:, keep], *want[1:])):
        a, w = a.cpu().numpy().astype(np.float64), w.cpu().numpy().astype(np.float64)
        assert np.isfinite(a).all()
        scale = np.abs(w).max(axis=-1, keepdims=True) if a.ndim == 2 else np.abs(w).max()
        big = np.abs(w) > 1e-3 * np.maximum(scale, 1e-30)
        np.testing.assert_allclose(a[big], w[big], rtol=5e-2, atol=1e-12)


def _level_two_states(scene, dev):
    """2^15 camera rays (128x64 at alias 2) and their first compacted level."""
    cfg = RenderConfig(width=128, height=64, max_depth=2, alias_factor=2)
    chunk, ws, cap, n = wavefront.wavefront_sizes(cfg, 1 << 15, 2)
    state, pid = wavefront.chunk_camera_state(cfg, chunk, n, 0, cfg.num_pixels,
                                              device=dev)
    _, kids = wavefront.wf_level(scene, state, True)
    return state, wavefront.compact(kids, pid, min(2 * chunk, cap), ws)[0]


@pytest.mark.parametrize("spawn", [True, False])
def test_level_backward_kernel_matches_plain_version(dev, spawn):
    scene = random_scene(32, seed=3, device=dev)
    for i, state in enumerate(_level_two_states(scene, dev)):
        em_ct, ch_ct, keep, sel = masked_level_cotangents(scene, state, spawn, seed=i)
        before = wavefront.WF_LEVEL_BWD.launches
        got = wavefront.wf_level_bwd(scene, state, em_ct, ch_ct, spawn, sel=sel)
        torch.cuda.synchronize()
        assert wavefront.WF_LEVEL_BWD.launches == before + 1
        want = wavefront.wf_level_bwd_torch(scene, state, em_ct, ch_ct, spawn)
        assert_level_grads(got, want, keep, state)
        none = wavefront.wf_level_bwd(scene, state, em_ct, ch_ct, spawn,
                                      need_state=False, sel=sel)
        assert none[0] is None


def test_level_backward_global_table_instance(dev):
    """3000 spheres: the gradient table outgrows shared memory, so K4 adds
    into the global table; K2 refuses the scene."""
    scene = random_scene(3000, seed=3, device=dev)
    assert trace_cuda._bwd_shared_bytes(3000, scene.lights.count) > trace_cuda.SMEM_BYTES
    cfg = RenderConfig(width=32, height=16, max_depth=1, alias_factor=1)
    chunk, _, _, n = wavefront.wavefront_sizes(cfg, 1 << 13, 2)
    state, _ = wavefront.chunk_camera_state(cfg, chunk, n, 0, cfg.num_pixels,
                                            device=dev)
    em_ct, ch_ct, keep, sel = masked_level_cotangents(scene, state, True, seed=3)
    got = wavefront.wf_level_bwd(scene, state, em_ct, ch_ct, True, sel=sel)
    torch.cuda.synchronize()
    assert_level_grads(got, wavefront.wf_level_bwd_torch(scene, state, em_ct, ch_ct, True),
                       keep, state)


def test_uncompact_kernel_is_bit_identical_to_plain_version(dev):
    scene = random_scene(32, seed=3, device=dev)
    cfg, ws, cap, (state, pid) = _level_states(scene, dev)
    _, kids = wavefront.wf_level(scene, state, True)
    rng = np.random.default_rng(4)
    n_alive = int((kids[6:9] != 0).any(dim=0).sum())
    for keep in (min(2 * state.shape[1], cap), n_alive // 2):
        got = wavefront.compact(kids, pid, keep, ws, return_src=True)
        want = wavefront.compact_torch(kids, pid, keep, ws, return_src=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        d = torch.tensor(rng.normal(size=(10, keep)).astype(np.float32), device=dev)
        before = wavefront.WF_UNCOMPACT.launches
        out = wavefront.uncompact(d, got[4], kids.shape[1])
        torch.cuda.synchronize()
        assert wavefront.WF_UNCOMPACT.launches == before + 1
        assert torch.equal(out, wavefront.uncompact_torch(d, got[4], kids.shape[1]))


def test_loss_and_grad_wavefront_matches_kernel_pair(dev):
    """tests/test_wavefront.py:196-219's case and contract: loss rtol 1e-5,
    every leaf within 2e-3 * max |K2's|; K3/K4 once per level and chunk,
    K5 twice and K6 once per compaction."""
    from raytpu_torch.grad import loss_and_grad_wavefront

    cfg = RenderConfig(width=64, height=48, max_depth=3, alias_factor=1)
    scene = random_scene(24, num_lights=2, seed=5, device=dev)
    target = torch.zeros(cfg.num_pixels, 3, device=dev)
    counts = [k.launches for k in (wavefront.WF_LEVEL, wavefront.WF_LEVEL_BWD,
                                   wavefront.WF_COMPACT, wavefront.WF_UNCOMPACT)]
    lw, gw = loss_and_grad_wavefront(scene, cfg, target, chunk_rays=1024)
    torch.cuda.synchronize()
    chunks = wavefront.wavefront_sizes(cfg, 1024, 2.0)[3]
    assert [k.launches - c for k, c in zip(
        (wavefront.WF_LEVEL, wavefront.WF_LEVEL_BWD, wavefront.WF_COMPACT,
         wavefront.WF_UNCOMPACT), counts)] == [chunks * 4, chunks * 4,
                                               chunks * 3 * 2, chunks * 3]
    lp, gp = loss_and_grad(scene, cfg, target, backend="cuda")
    np.testing.assert_allclose(float(lw), float(lp), rtol=1e-5)
    for a, b in zip(scene_leaves(gw), scene_leaves(gp)):
        a, b = a.cpu().numpy(), b.cpu().numpy()
        assert np.abs(a - b).max() <= 2e-3 * max(float(np.abs(b).max()), 1e-12)


def test_fit_scene_wavefront_escalates_the_ladder(dev):
    """The frame-filling transparent sphere overflows capacity 1: the
    dropped step is discarded and re-run at the next rung."""
    from raytpu_torch.grad import fit_scene, loss_and_grad_wavefront
    from raytpu_torch.render import DroppedRaysError
    from raytpu_torch.scene import build_scene, make_material

    mat = make_material(0.3, (0.2, 0.4, 0.6), (0.9, 0.9, 0.9), opacity=0.0, ior=1.5)
    scene = build_scene(sphere_specs=[((0.0, 0.0, -10.0), 9.9, mat)],
                        light_specs=[((10.0, 30.0, 10.0), (0.5, 0.5, 0.5))],
                        device=dev)
    cfg = RenderConfig(width=128, height=64, max_depth=2, alias_factor=1)
    target = torch.zeros(cfg.num_pixels, 3, device=dev)
    with pytest.raises(DroppedRaysError):
        loss_and_grad_wavefront(scene, cfg, target, chunk_rays=256, capacity_factor=1)
    with pytest.warns(RuntimeWarning, match="auto-capacity"):
        _, losses = fit_scene(scene, cfg, target, steps=1, backend="wavefront",
                              wf_opts=dict(chunk_rays=256))
    assert len(losses) == 1 and np.isfinite(losses[0])


def test_wavefront_backward_raises_on_what_it_does_not_take(dev):
    from raytpu_torch.grad import loss_and_grad_wavefront

    scene = default_scene(device=dev)
    cfg, ws, cap, (state, pid) = _level_states(scene, dev)
    rays = state.shape[1]
    em_ct = torch.ones(3, rays, device=dev)
    ch_ct = torch.zeros(10, 2 * rays, device=dev)
    with pytest.raises(TypeError):
        wavefront.wf_level_bwd(scene, state.double(), em_ct, ch_ct, True)
    with pytest.raises(ValueError):   # one emission cotangent short
        wavefront.wf_level_bwd(scene, state, em_ct[:, :-1].contiguous(), ch_ct, True)
    with pytest.raises(ValueError):   # children's cotangent for R, not 2R, rays
        wavefront.wf_level_bwd(scene, state, em_ct, ch_ct[:, :rays].contiguous(), True)
    with pytest.raises(ValueError):   # state on the CPU, scene on the card
        wavefront.wf_level_bwd(scene, state.cpu(), em_ct, ch_ct, True)
    _, kids, sel = wavefront.wf_level(scene, state, True, return_sel=True)
    with pytest.raises(ValueError):   # no selections
        wavefront.wf_level_bwd(scene, state, em_ct, ch_ct, True)
    with pytest.raises(ValueError):   # selections of another state
        wavefront.wf_level_bwd(scene, state, em_ct, ch_ct, True,
                               sel=sel[:, :-1].contiguous())
    src = wavefront.compact(kids, pid, cap, ws, return_src=True)[4]
    d = torch.zeros(10, cap, device=dev)
    with pytest.raises(TypeError):
        wavefront.uncompact(d, src.long(), kids.shape[1])
    with pytest.raises(ValueError):
        wavefront.uncompact(d[:, :-1].contiguous(), src, kids.shape[1])
    with pytest.raises(TypeError):
        wavefront.uncompact(d.double(), src, kids.shape[1])
    with pytest.raises(ValueError):
        loss_and_grad_wavefront(scene, RenderConfig(
            width=8, height=8, max_depth=trace_cuda.MAX_DEPTH + 1),
            torch.zeros(64, 3, device=dev))


def test_training_auto_takes_the_measured_crossover(dev):
    from raytpu_torch.grad import resolve_train_backend

    scene = default_scene(device=dev)
    small = RenderConfig(width=40, height=30, max_depth=2)
    assert resolve_train_backend("auto", scene, BENCH_CONFIGS["config3"]) == "wavefront"
    assert resolve_train_backend("auto", scene, small) == "cuda"
    # K2 cannot stage 3000 spheres' tables: the wavefront at any size.
    assert resolve_train_backend("auto", random_scene(3000, device=dev), small) == "wavefront"


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.parametrize("n_spheres", [256, 3000])
def test_level_kernel_through_the_tree_matches_its_reference(dev, n_spheres):
    """K3 through the BVH (staged in shared memory at 256 spheres, read
    through the read-only cache at 3000) against its brute-force reference
    instance, bit for bit: emissions, children, sel; over two levels."""
    scene = random_scene(n_spheres, seed=3, device=dev)
    cfg = RenderConfig(width=64, height=32, max_depth=2, alias_factor=2)
    chunk, ws, cap, n = wavefront.wavefront_sizes(cfg, 4096, 2)
    state, pid = wavefront.chunk_camera_state(cfg, chunk, n, 0, cfg.num_pixels,
                                              device=dev)
    for _ in range(2):
        before = wavefront.WF_LEVEL.launches
        got = wavefront.wf_level(scene, state, True, return_sel=True)
        want = wavefront.wf_level_reference(scene, state, True, return_sel=True)
        torch.cuda.synchronize()
        assert wavefront.WF_LEVEL.launches == before + 1  # the reference is not counted
        for a, b in zip(got, want):
            assert torch.equal(_bits(a), _bits(b))
        assert (got[2][0] >= 0).any()
        state, pid = wavefront.compact(got[1], pid, min(2 * state.shape[1], cap), ws)[:2]


@pytest.mark.parametrize("spawn", [True, False])
def test_level_backward_from_sel_matches_its_reference(dev, spawn):
    """K4 from K3's selections against its reference instance, which re-runs
    the brute-force queries: d_state bit for bit, the tables within 1e-5 x
    scale (atomics' order)."""
    scene = random_scene(32, seed=3, device=dev)
    for i, state in enumerate(_level_two_states(scene, dev)):
        em_ct, ch_ct, _, sel = masked_level_cotangents(scene, state, spawn, seed=i)
        before = wavefront.WF_LEVEL_BWD.launches
        got = wavefront.wf_level_bwd(scene, state, em_ct, ch_ct, spawn, sel=sel)
        want = wavefront.wf_level_bwd_reference(scene, state, em_ct, ch_ct, spawn)
        torch.cuda.synchronize()
        assert wavefront.WF_LEVEL_BWD.launches == before + 1
        assert torch.equal(_bits(got[0]), _bits(want[0]))
        for a, b in zip(got[1:], want[1:]):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
