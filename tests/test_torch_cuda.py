"""The CUDA kernels (dense forward and backward, the wavefront's level and
compaction and their backwards, the strict-semantics oracle) against their
plain PyTorch versions, on a card, and the paths that launch them.

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
tests/test_wavefront.py:196-219's (every leaf within 2e-3*scale), also
over checkpointed chunks on side streams.  The
level kernel through its BVH and the level backward from the saved
selections are held to their brute-force reference instances bit for bit
(the backward's atomically summed tables within 1e-5 x scale), and the
dense backward to its reference instance (the previous design) within
1e-5 x scale.  Beyond the dense kernels' bounds (depth above MAX_DEPTH,
more than MAX_SPHERES spheres or MAX_LIGHTS lights) "auto" renders and
trains through the wavefront, held to the plain versions; a pixel subset
trains through the eager tracer.  The oracle kernel is held bit for bit,
NaN masks equal, to its plain version (raytpu_torch.oracle) and to its g++
host build under the golden-residual experiments' masks; the scene
builders put a scene built without a device on the card.  raytpu's
packed-tile step launches the kernel pair once each and matches the flat
step, and the culling masks on the card equal the CPU's.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from raytpu_torch.config import BENCH_CONFIGS, RenderConfig
from raytpu_torch.grad import loss_and_grad
from raytpu_torch.kernels import trace_cuda, wavefront
from raytpu_torch.kernels.trace_cuda import (grad_pixels_cuda,
                                             grad_pixels_reference,
                                             grad_pixels_torch,
                                             render_pixels_cuda,
                                             render_pixels_cuda_ad,
                                             render_pixels_reference,
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
    assert resolve_backend("auto", device=dev) == "cuda"
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


def test_packed_step_runs_the_kernel_pair(dev):
    """loss_and_grad_packed on the card: one K1 and one K2 launch, the
    flat step's loss (rtol 1e-6) and gradient (1e-5 x max |leaf|: K2 sums
    with atomics), and a raise on a scene the kernels do not take."""
    from raytpu_torch.grad import loss_and_grad_packed, pack_target

    scene = default_scene(device=dev)
    cfg = RenderConfig(width=40, height=30, max_depth=2, alias_factor=2)
    target = render_pixels_cuda(scene, cfg) * 1.15
    packed = pack_target(cfg, target)
    fwd, bwd = trace_cuda.TRACE_FWD.launches, trace_cuda.TRACE_BWD.launches
    loss, grads = loss_and_grad_packed(scene, cfg, packed)
    assert trace_cuda.TRACE_FWD.launches == fwd + 1
    assert trace_cuda.TRACE_BWD.launches == bwd + 1
    flat_loss, flat_grads = loss_and_grad(scene, cfg, target, backend="cuda")
    np.testing.assert_allclose(float(loss), float(flat_loss), rtol=1e-6)
    for a, w in zip(scene_leaves(grads), scene_leaves(flat_grads)):
        assert float((a - w).abs().max()) <= 1e-5 * float(w.abs().max())
    with pytest.raises(ValueError):
        loss_and_grad_packed(scene, RenderConfig(
            width=8, height=8, max_depth=trace_cuda.MAX_DEPTH + 1), packed)


def test_culling_masks_on_the_card_equal_the_cpu(dev):
    from raytpu_torch.kernels import culling

    scene = random_scene(64, seed=3, device=dev)
    cfg = RenderConfig(width=128, height=64, max_depth=1, alias_factor=2)
    chunk, _, _, n = wavefront.wavefront_sizes(cfg, 1 << 14, 1)
    state, _ = wavefront.chunk_camera_state(cfg, chunk, n, 0, cfg.num_pixels,
                                            device=dev)
    bounds = culling.tile_bounds(list(state[:6]), 256)
    live = culling.beam_live_mask(bounds, scene.spheres.pos, scene.spheres.radius)
    cpu = culling.beam_live_mask(culling.tile_bounds(list(state[:6].cpu()), 256),
                                 scene.spheres.pos.cpu(), scene.spheres.radius.cpu())
    assert torch.equal(live.cpu(), cpu)


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
    # A depth beyond the dense kernels' stack: the wavefront takes it.
    deep = RenderConfig(width=8, height=8, max_depth=trace_cuda.MAX_DEPTH + 1,
                        alias_factor=1)
    img = wavefront.render_pixels_wavefront(scene, deep)
    assert_wavefront_contract(img, render_pixels_torch(scene, deep))


def assert_wavefront_contract(got, want):
    """tests/test_wavefront.py:25-36: outliers at 1e-3*scale <= 0.5%, mean
    abs diff < 1e-4*scale."""
    got = got.reshape(-1, 3).cpu().numpy()
    want = want.reshape(-1, 3).cpu().numpy()
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    d = np.abs(got - want)
    assert (d.max(axis=-1) > 1e-3 * scale).mean() <= 0.005
    assert d.mean() < 1e-4 * scale


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
        got = wavefront.compact(kids, pid, keep, ws, return_dst=True)
        want = wavefront.compact_torch(kids, pid, keep, ws, return_dst=True)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        d = torch.tensor(rng.normal(size=(10, keep)).astype(np.float32), device=dev)
        before = wavefront.WF_UNCOMPACT.launches
        out = wavefront.uncompact(d, got[4], keep)
        torch.cuda.synchronize()
        assert wavefront.WF_UNCOMPACT.launches == before + 1
        assert torch.equal(out, wavefront.uncompact_torch(d, got[4], keep))


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


def test_streams_and_checkpointed_chunks_on_the_card(dev):
    """A 3-chunk frame at streams 1, 2 and 3 (chunk c on side stream c %
    streams): the same frame within 1e-6 * max (index_add_'s atomics) and
    the same drops; its training step at streams 1 and 2 checkpoints each
    chunk (K3 and K5 twice a chunk, K4 and K6 once) and holds K1 + K2's
    loss and leaves as above."""
    from raytpu_torch.grad import loss_and_grad_sharded
    from raytpu_torch.parallel.mesh import Mesh

    cfg = RenderConfig(width=160, height=120, max_depth=2, alias_factor=1)
    scene = random_scene(24, num_lights=2, seed=5, device=dev)
    chunks = wavefront.wavefront_sizes(cfg, 8192, 2)[3]
    assert chunks == 3
    frames = [wavefront.render_pixels_wavefront(scene, cfg, chunk_rays=8192,
                                                streams=s, return_info=True)
              for s in (1, 2, 3)]
    scale = float(frames[0][0].abs().max())
    for img, info in frames:
        assert int(info["dropped"]) == 0
        assert float((img - frames[0][0]).abs().max()) <= 1e-6 * scale
    target = torch.zeros(cfg.num_pixels, 3, device=dev)
    lp, gp = loss_and_grad(scene, cfg, target, backend="cuda")
    kernels = (wavefront.WF_LEVEL, wavefront.WF_LEVEL_BWD, wavefront.WF_COMPACT,
               wavefront.WF_UNCOMPACT)
    for streams in (1, 2):
        counts = [k.launches for k in kernels]
        lw, gw = loss_and_grad_sharded(scene, cfg, target, Mesh(0, 1, dev),
                                       "wavefront", wf_opts=dict(
                                           chunk_rays=8192, capacity_factor=2.0,
                                           streams=streams))
        torch.cuda.synchronize()
        assert [k.launches - c for k, c in zip(kernels, counts)] == [
            2 * chunks * 3, chunks * 3, 2 * chunks * 2 * 2, chunks * 2]
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
    dst = wavefront.compact(kids, pid, cap, ws, return_dst=True)[4]
    d = torch.zeros(10, cap, device=dev)
    with pytest.raises(TypeError):
        wavefront.uncompact(d, dst.long(), cap)
    with pytest.raises(ValueError):
        wavefront.uncompact(d[:, :-1].contiguous(), dst, cap)
    with pytest.raises(ValueError):
        wavefront.uncompact(d[:9].contiguous(), dst, cap)
    with pytest.raises(TypeError):
        wavefront.uncompact(d.double(), dst, cap)
    # A depth beyond the dense kernels' stack: the wavefront trains it.
    loss, grads = loss_and_grad_wavefront(scene, RenderConfig(
        width=8, height=8, max_depth=trace_cuda.MAX_DEPTH + 1),
        torch.zeros(64, 3, device=dev))
    assert torch.isfinite(loss) and all(torch.isfinite(t).all()
                                        for t in scene_leaves(grads))


def test_training_auto_takes_the_measured_crossover(dev):
    from raytpu_torch.grad import resolve_train_backend

    scene = default_scene(device=dev)
    small = RenderConfig(width=40, height=30, max_depth=2)
    assert resolve_train_backend("auto", scene, BENCH_CONFIGS["config3"]) == "cuda"
    assert resolve_train_backend("auto", random_scene(64, seed=3, device=dev),
                                 BENCH_CONFIGS["config3"]) == "wavefront"
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


@pytest.mark.parametrize("case", ["default_d3_a3", "random32_d1", "stride",
                                  "lights40_d2"])
def test_backward_kernel_matches_its_reference(dev, case):
    """K2 (one tree a camera sample, saved selections, a gradient table a
    thread where it fits) against its reference instance, the previous
    design: every table within 1e-5 x its scale (atomics' order), on the
    lane-table instance (N = 3) and the shared-table one (N = 32, and 40
    lights)."""
    scene, cfg, sel = {
        "default_d3_a3": (default_scene(device=dev),
                          RenderConfig(width=64, height=32, max_depth=3, alias_factor=3), {}),
        "random32_d1": (random_scene(32, seed=3, device=dev),
                        RenderConfig(width=64, height=16, max_depth=1, alias_factor=1), {}),
        "stride": (default_scene(device=dev),
                   RenderConfig(width=64, height=32, max_depth=2, alias_factor=2),
                   dict(offset=5, stride=3, count=600)),
        "lights40_d2": (random_scene(6, num_lights=40, seed=1, spread=5.0, device=dev),
                        RenderConfig(width=48, height=32, max_depth=2, alias_factor=2), {}),
    }[case]
    count = sel.get("count", cfg.num_pixels)
    rng = np.random.default_rng(5)
    g = torch.tensor(rng.uniform(0.5, 1.5, (count, 3)).astype(np.float32), device=dev)
    before = trace_cuda.TRACE_BWD.launches
    got = grad_pixels_cuda(scene, cfg, g, **sel)
    want = grad_pixels_reference(scene, cfg, g, **sel)
    torch.cuda.synchronize()
    assert trace_cuda.TRACE_BWD.launches == before + 1  # the reference is not counted
    for a, w in zip(scene_leaves(got), scene_leaves(want)):
        assert torch.isfinite(a).all()
        assert float((a - w).abs().max()) <= 1e-5 * max(float(w.abs().max()), 1e-30)


@pytest.mark.parametrize("case", ["a1", "a2", "a3", "a4", "stride", "a12",
                                  "N4096_L1024"])
def test_forward_kernel_matches_its_reference(dev, case):
    """K1 (a thread a camera sample, the samples summed in pixel_forward's
    order) against its reference instance, the previous design (a thread a
    pixel): bit for bit, at alias 1-4, on a strided set with a clamped
    tail, at alias 12 (two rounds of a block's 128 sample slots a pixel)
    and at the largest tables the kernel takes."""
    scene, cfg, sel = {
        "a1": (default_scene(device=dev),
               RenderConfig(width=64, height=32, max_depth=3, alias_factor=1), {}),
        "a2": (random_scene(32, seed=3, device=dev),
               RenderConfig(width=64, height=32, max_depth=2, alias_factor=2), {}),
        "a3": (default_scene(device=dev),
               RenderConfig(width=64, height=32, max_depth=4, alias_factor=3), {}),
        "a4": (default_scene(device=dev),
               RenderConfig(width=50, height=17, max_depth=3, alias_factor=4), {}),
        "stride": (default_scene(device=dev),
                   RenderConfig(width=64, height=32, max_depth=2, alias_factor=3),
                   dict(offset=5, stride=3, count=701)),
        "a12": (default_scene(device=dev),
                RenderConfig(width=16, height=8, max_depth=2, alias_factor=12),
                dict(offset=3, stride=5, count=29)),
        "N4096_L1024": (random_scene(trace_cuda.MAX_SPHERES,
                                     num_lights=trace_cuda.MAX_LIGHTS, seed=4,
                                     device=dev),
                        RenderConfig(width=8, height=4, max_depth=1, alias_factor=2), {}),
    }[case]
    before = trace_cuda.TRACE_FWD.launches
    got = render_pixels_cuda(scene, cfg, **sel)
    want = render_pixels_reference(scene, cfg, **sel)
    torch.cuda.synchronize()
    assert trace_cuda.TRACE_FWD.launches == before + 1  # the reference is not counted
    assert torch.isfinite(got).all()
    assert torch.equal(_bits(got.contiguous()), _bits(want.contiguous()))


def _seeded_children(parents, live_frac, seed, dev):
    """(10, 2 * parents) children as K3 writes them (a dead child is ten
    exact zeros) and the parents' pids, on the card."""
    rng = np.random.default_rng(seed)
    kids = 2 * parents
    ch = rng.normal(size=(10, kids)).astype(np.float32)
    ch[9] = rng.integers(-1, 8, kids)
    ch[6:9][:, rng.random(kids) < 0.5] = 0.0
    ch[6 + rng.integers(0, 3, kids), np.arange(kids)] = 0.5 + rng.random(kids)
    ch[:, rng.random(kids) >= live_frac] = 0.0
    pid = rng.integers(0, 1 << 20, parents).astype(np.int32)
    return torch.from_numpy(ch).to(dev), torch.from_numpy(pid).to(dev)


COMPACT_CASES = {
    # name: (parents, live fraction, capacity)
    "no children": (0, 0.5, 4096),
    "less than a tile": (300, 0.6, 1024),
    "every child dead": (3000, 0.0, 2048),
    "every child live": (3000, 1.0, 8192),
    "capacity below the live count": (5000, 0.7, 3000),
    "capacity above the children": (1000, 0.5, 9000),
    "a long look-back chain": (1 << 21, 0.45, 1 << 21),
}


@pytest.mark.parametrize("with_dst", [False, True])
@pytest.mark.parametrize("case", sorted(COMPACT_CASES))
def test_compaction_edge_cases(dev, case, with_dst):
    """K5 (the single-pass scan and the tail) bit for bit against
    compact_torch; the scan launches only where there are children."""
    parents, live_frac, cap = COMPACT_CASES[case]
    children, pid = _seeded_children(parents, live_frac, len(case), dev)
    before = wavefront.WF_COMPACT.launches
    got = wavefront.compact(children, pid, cap, 37, return_dst=with_dst)
    torch.cuda.synchronize()
    assert wavefront.WF_COMPACT.launches == before + (parents > 0) + (cap > 0)
    want = wavefront.compact_torch(children, pid, cap, 37, return_dst=with_dst)
    assert len(got) == len(want)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


def test_compactions_back_to_back_on_one_stream(dev):
    """Compactions enqueued one after another with no synchronisation, the
    first one's outputs freed so that the allocator may hand its scratch
    (status words and ticket) to the next: each still equals
    compact_torch."""
    inputs = [_seeded_children(40000 + 999 * k, 0.3 + 0.2 * k, 50 + k, dev)
              for k in range(3)]
    wants = [wavefront.compact_torch(ch, pid, 50000, 101, return_dst=True)
             for ch, pid in inputs]
    torch.cuda.synchronize()
    kept = []
    for rep in range(2):
        for (ch, pid), want in zip(inputs, wants):
            got = wavefront.compact(ch, pid, 50000, 101, return_dst=True)
            if rep == 1:
                kept.append((got, want))
            del got
    torch.cuda.synchronize()
    for got, want in kept:
        assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip(got, want))


def test_auto_renders_beyond_the_dense_bounds(dev):
    """Depth 10, 5000 spheres at depth 0, 1100 lights: render "auto" takes
    the wavefront (K3 through the read-only cache or in place, K5), held to
    the plain version; an explicit "cuda" raises naming the bound."""
    cases = [
        (default_scene(device=dev), RenderConfig(width=64, height=48, max_depth=10,
                                                 alias_factor=1)),
        (random_scene(5000, seed=3, device=dev),
         RenderConfig(width=64, height=48, max_depth=0, alias_factor=1)),
        (random_scene(8, num_lights=1100, seed=2, spread=5.0, device=dev),
         RenderConfig(width=64, height=48, max_depth=2, alias_factor=1)),
    ]
    for scene, cfg in cases:
        assert resolve_backend("auto", scene, cfg, device=dev) == "wavefront"
        before = wavefront.WF_LEVEL.launches
        img = render_single(scene, cfg)
        torch.cuda.synchronize()
        assert wavefront.WF_LEVEL.launches > before
        assert_wavefront_contract(img, render_single(scene, cfg, backend="torch"))
        with pytest.raises(ValueError, match="max_depth|spheres|lights"):
            render_single(scene, cfg, backend="cuda")


def test_auto_trains_beyond_the_dense_bounds(dev):
    """Training "auto" at depth 10, at 5000 spheres and at 1100 lights is
    the wavefront (K3 and K4 with the scene read in place at 5000); its
    gradient against the plain version's on a cotangent zeroed where the
    forwards differ."""
    from raytpu_torch.grad import resolve_train_backend

    for scene, cfg in (
            (default_scene(device=dev),
             RenderConfig(width=64, height=48, max_depth=10, alias_factor=1)),
            (random_scene(5000, seed=3, device=dev),
             RenderConfig(width=64, height=48, max_depth=2, alias_factor=1)),
            (random_scene(8, num_lights=1100, seed=2, spread=5.0, device=dev),
             RenderConfig(width=64, height=48, max_depth=2, alias_factor=1))):
        assert resolve_train_backend("auto", scene, cfg) == "wavefront"
        loss, grads = loss_and_grad(scene, cfg, torch.zeros(cfg.num_pixels, 3, device=dev))
        assert torch.isfinite(loss)
        leaves = [t.clone().requires_grad_(True) for t in scene_leaves(scene)]
        img = wavefront.render_pixels_wavefront(scene_from_leaves(leaves), cfg)
        plain = render_pixels_torch(scene, cfg)
        assert_wavefront_contract(img.detach(), plain)
        bad = (img.detach() - plain).abs().amax(dim=1) > 1e-5 * plain.abs().max()
        g = torch.ones_like(plain)
        g[bad] = 0.0
        got = torch.autograd.grad(torch.sum(img * g), leaves, allow_unused=True)
        want = grad_pixels_torch(scene, cfg, g)
        for a, w in zip(got, scene_leaves(want)):
            a = torch.zeros_like(w) if a is None else a
            a, w = a.cpu().numpy().ravel(), w.cpu().numpy().ravel()
            big = np.abs(w) > 1e-3 * max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(a[big], w[big], rtol=5e-2, atol=1e-12)


def test_pixel_subset_trains_on_a_cuda_scene(dev):
    """image_loss and exposure_image_loss with a strided gid under "auto" on
    a CUDA scene (the eager tracer), against the same calls on the CPU."""
    from raytpu_torch.grad import exposure_image_loss, image_loss

    cfg = RenderConfig(width=40, height=30, max_depth=2, alias_factor=2)
    rng = np.random.default_rng(3)
    target = rng.uniform(0, 1e-4, (cfg.num_pixels, 3)).astype(np.float32)
    gid = np.arange(3, cfg.num_pixels, 7)
    for fn in (image_loss, exposure_image_loss):
        got = fn(default_scene(device=dev), cfg, torch.tensor(target, device=dev),
                 gid=torch.tensor(gid, device=dev))
        want = fn(default_scene(device="cpu"), cfg, torch.tensor(target),
                  gid=torch.tensor(gid))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-4)
        with pytest.raises(ValueError):
            fn(default_scene(device=dev), cfg, torch.tensor(target, device=dev),
               gid=torch.tensor(gid, device=dev), backend="cuda")


def test_level_kernels_take_a_scene_beyond_shared_memory(dev):
    """5000 spheres: K3 reads the scene table and the tree in place, K4 the
    scene table, both against their plain versions (the reference
    instances stage the table in shared memory and refuse it)."""
    scene = random_scene(5000, seed=3, device=dev)
    cfg = RenderConfig(width=32, height=16, max_depth=1, alias_factor=1)
    chunk, _, _, n = wavefront.wavefront_sizes(cfg, 1 << 13, 2)
    state, _ = wavefront.chunk_camera_state(cfg, chunk, n, 0, cfg.num_pixels,
                                            device=dev)
    em, kids, sel = wavefront.wf_level(scene, state, True, return_sel=True)
    pem, pkids = wavefront.wf_level_torch(scene, state, True)
    contract(em.T, pem.T)
    assert (~torch.isclose(kids, pkids, rtol=1e-5, atol=1e-6).all(dim=0)).float().mean() <= 0.01
    em_ct, ch_ct, keep, sel = masked_level_cotangents(scene, state, True, seed=3)
    got = wavefront.wf_level_bwd(scene, state, em_ct, ch_ct, True, sel=sel)
    torch.cuda.synchronize()
    assert_level_grads(got, wavefront.wf_level_bwd_torch(scene, state, em_ct, ch_ct, True),
                       keep, state)
    with pytest.raises(ValueError):
        wavefront.wf_level_reference(scene, state, True)


def test_sharded_paths_in_a_world_of_one(dev, capsys):
    """Without a process group, render_sharded is render_single bit for bit
    (K1, block and interleaved), render_timed(mesh=) and the CLI's
    --sharded --time report one rank, and loss_and_grad_sharded through K1 +
    K2 is loss_and_grad's (loss rtol 1e-5, every leaf within 2e-3 x scale:
    K2 sums with atomics)."""
    from raytpu_torch import cli
    from raytpu_torch.grad import loss_and_grad_sharded
    from raytpu_torch.parallel import make_mesh
    from raytpu_torch.render import render_sharded, render_timed

    scene = default_scene(device=dev)
    cfg = RenderConfig(width=65, height=33, max_depth=3, alias_factor=2)
    mesh = make_mesh(dev)
    assert (mesh.size, mesh.group) == (1, None)
    one = render_single(scene, cfg, "cuda")
    for interleave in (False, True):
        assert torch.equal(render_sharded(scene, cfg, mesh, "cuda",
                                          interleave=interleave), one)
    img, stats = render_timed(scene, cfg, backend="wavefront", mesh=mesh,
                              interleave=True)
    assert stats["ranks"] == 1 and stats["dropped"] == 0 and img.shape == one.shape
    target = 0.5 * one.reshape(-1, 3)
    loss, grads = loss_and_grad_sharded(scene, cfg, target, mesh, "cuda")
    want_loss, want = loss_and_grad(scene, cfg, target, "cuda")
    assert abs(float(loss) - float(want_loss)) <= 1e-5 * abs(float(want_loss))
    for a, b in zip(scene_leaves(grads), scene_leaves(want)):
        assert float((a - b).abs().max()) <= 2e-3 * max(float(b.abs().max()), 1e-30)
    assert cli.main(["--width", "64", "--height", "48", "--max-depth", "2",
                     "--alias-factor", "1", "--sharded", "--interleave",
                     "--time"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["ranks"] == 1 and stats["interleave"] is True


def test_builders_default_to_the_card(dev, tmp_path):
    """Without a device every builder and load_scene put the scene on the
    card, and render_single on it launches K1 once."""
    from raytpu_torch.scene import single_sphere_scene
    from raytpu_torch.scene_io import load_scene, save_scene

    path = str(tmp_path / "scene.json")
    save_scene(default_scene(device="cpu"), path)
    for scene in (default_scene(), single_sphere_scene(), random_scene(4, seed=1),
                  load_scene(path)):
        assert scene.device.type == "cuda"
    before = trace_cuda.TRACE_FWD.launches
    img = render_single(default_scene(),
                        RenderConfig(width=32, height=24, max_depth=2, alias_factor=1))
    torch.cuda.synchronize()
    assert trace_cuda.TRACE_FWD.launches == before + 1
    assert img.device.type == "cuda" and bool(torch.isfinite(img).all())


# The oracle kernel (raytpu_torch/csrc/oracle.cu): its plain version's cases
# of tests/test_torch_oracle.py at their sizes, bit for bit with equal NaN
# masks, and its host build under the experiments' masks.
ORACLE_FRAMES = {
    "default 96x72 cap5": (lambda d: default_scene(bg_opacity=0.0, device=d),
                           RenderConfig(width=96, height=72), 5, False),
    "default 64x48 cap6 double": (lambda d: default_scene(bg_opacity=0.0, device=d),
                                  RenderConfig(width=64, height=48), 6, True),
    "random24 48x32 a2 cap5": (lambda d: random_scene(24, seed=7, device=d),
                               RenderConfig(width=48, height=32, alias_factor=2),
                               5, False),
}


def same_oracle_bits(got, want) -> bool:
    got, want = got.detach().cpu().reshape(-1), want.detach().cpu().reshape(-1)
    nan = torch.isnan(want)
    return bool(torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


@pytest.mark.parametrize("name", sorted(ORACLE_FRAMES))
def test_oracle_kernel_matches_its_plain_version(dev, name):
    from raytpu_torch.native import ORACLE, render_native
    from raytpu_torch.oracle import render_oracle

    build, cfg, cap, double = ORACLE_FRAMES[name]
    scene = build(dev)
    before = ORACLE.launches
    got = render_native(scene, cfg, cap=cap, fresnel_double=double)
    torch.cuda.synchronize()
    assert ORACLE.launches == before + 1
    assert got.shape == (cfg.height, cfg.width, 3) and got.device == scene.device
    assert same_oracle_bits(got, render_oracle(scene, cfg, cap=cap,
                                               fresnel_double=double))


@pytest.fixture(scope="module")
def oracle_host(tmp_path_factory):
    import ctypes
    import shutil
    import subprocess

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU harness of the CUDA sources")
    src = trace_cuda.CSRC / "oracle.cu"
    lib_path = tmp_path_factory.mktemp("oracle") / "liboracle_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(lib_path), str(src)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib_path)).raytpu_oracle_host
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [p, i, p, i, p, i, i, f, f, f, i, i, i, i, i, ll, ll, p]
    fn.restype = None
    return fn


@pytest.mark.parametrize("masks", [(0, 0), (1, 0), (0, 1), (4, 0), (0, 32)],
                         ids=lambda m: f"fma{m[0]}_approx{m[1]}")
def test_oracle_kernel_matches_its_host_build(dev, oracle_host, masks):
    """Under the golden-residual experiments' masks (the explicit fmaf,
    reciprocal and nextafterf on the card), on the whole frame and on an
    offset/count range."""
    from raytpu_torch.native import render_native

    fma, approx = masks
    scene = random_scene(24, seed=7, device=dev)
    cfg = RenderConfig(width=48, height=32, alias_factor=2)
    s, l, b = trace_cuda.scene_tables(scene.to("cpu"))
    for offset, count in ((0, cfg.num_pixels), (100, 333)):
        want = torch.full((count, 3), float("nan"))
        oracle_host(s.data_ptr(), scene.spheres.count, l.data_ptr(),
                    scene.lights.count, b.data_ptr(), cfg.width, cfg.height,
                    cfg.zoom, cfg.image_world_width, cfg.image_world_height,
                    cfg.alias_factor, 5, 0, fma, approx, offset, count,
                    want.data_ptr())
        got = render_native(scene, cfg, offset=offset, count=count,
                            fma_mask=fma, approx_mask=approx)
        torch.cuda.synchronize()
        assert got.shape == (count, 3)
        assert same_oracle_bits(got, want)


def test_oracle_kernel_refuses_what_it_does_not_take(dev):
    from raytpu_torch.native import render_native

    scene = default_scene(device=dev)
    cfg = RenderConfig(width=8, height=6)
    for kw in (dict(cap=0), dict(fma_mask=32), dict(approx_mask=64),
               dict(offset=40, count=9)):
        with pytest.raises(ValueError):
            render_native(scene, cfg, **kw)


def test_bench_and_its_timing_on_the_card(dev):
    """raytpu_torch.bench's inner function at a small config: the forward
    and the step through the kernels ("auto" takes "cuda"), every timed key
    measured on the device, config 5 shrunk to random_scene(8) through the
    wavefront with no drop; Timer on the card times by CUDA events, and
    render_timed takes raytpu's positional mesh."""
    from raytpu_torch import bench
    from raytpu_torch.parallel import make_mesh
    from raytpu_torch.render import render_timed
    from raytpu_torch.utils.profiling import Timer

    cfg = RenderConfig(width=64, height=48, max_depth=2, alias_factor=1)
    line = bench.run(dev, cfg, cfg, cfg, config5_spheres=8)
    assert (line["fwd_backend"], line["fwd_bwd_backend"], line["backend"]) == (
        "cuda", "cuda", "cuda")
    assert line["value"] == line["step_device_mrays_per_s"] > 0
    assert line["fwd_device_ms"] > 0 and len(line["step_device_times_ms"]) == bench.REPS
    assert line["config5_dropped_rays"] == 0
    assert line["device"] == torch.cuda.get_device_name(dev)
    assert line["power_limit"].endswith("W")
    calls = bench.REPS + 1
    for key in ("fwd_bwd", "step_device", "golden_800x600_d5_fwd_bwd"):
        assert line["launches"][key] == {"trace_fwd": calls, "trace_bwd": calls,
                                         "wf_level": 0, "wf_compact": 0}, key
    c5 = line["launches"]["config5_1080p_d6_N256_wavefront"]
    assert c5["wf_level"] > 0 and c5["wf_compact"] > 0 and c5["trace_fwd"] == 0
    json.dumps(line)
    host = Timer()
    with host.section("k1") as box:
        box["value"] = render_pixels_cuda(default_scene(device=dev), cfg)
    assert host.device.type == "cpu" and host.summary()["k1"] > 0
    timer = Timer(dev)
    with timer.section("k1"):
        render_pixels_cuda(default_scene(device=dev), cfg)
    assert len(timer.times()["k1"]) == 1 and timer.summary()["k1"] > 0
    _, stats = render_timed(default_scene(device=dev), cfg, make_mesh(dev), 1, 2)
    assert stats["backend"] == "cuda" and stats["ranks"] == 1
    assert stats["device"] == torch.cuda.get_device_name(dev)


def test_bench_all_skip_large_launches_each_keys_kernels(dev, capsys):
    """raytpu_torch.tools.bench_all --skip-large on the card: configs 1-3
    and the golden frame, no stage failed, each forward one K1 launch a
    call, each step (the kernel pair) one K1 and one K2 a call, and no
    other kernel."""
    from raytpu_torch.tools import bench_all

    assert bench_all.main(["--skip-large"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["config"] for r in rows] == ["config1", "config2", "config3", "golden"]
    calls = 1 + bench_all.REPS
    none = dict.fromkeys(("trace_fwd", "trace_bwd", "wf_level", "wf_compact",
                          "wf_level_bwd", "wf_uncompact"), 0)
    for r in rows:
        assert not [k for k in r if k.endswith("_error")], r
        assert r["launches"] == {
            "fwd": dict(none, trace_fwd=calls),
            "fwd_bwd": dict(none, trace_fwd=calls, trace_bwd=calls)}, r
        assert r["fwd_ms"] > 0 and r["fwd_bwd_ms"] > 0
        assert r["device"] == torch.cuda.get_device_name(dev) and r["power_limit"]
