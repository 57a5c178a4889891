"""Posed cameras and multi-view fits (raytpu_torch.camera; the views= of
trace, the wavefront, render_sharded and grad), on the CPU:

  * the identity view is the reference camera bit for bit: frames on the
    eager tracer and the wavefront's plain versions, and the one-view step's
    loss, gradient and fit;
  * the posed SPD view of the world-space flake (level 2) is
    sphereflake_scene(2)'s moved scene's frame, and scene_in_view's frame
    is the posed rays' frame, under the port's pixel contract;
  * a 3-view step (loss, gradient, and the leaves after 2 Adam steps)
    matches the benchmark's plain reference (benchmark/reference/views.py)
    on seeded jittered level-1 and level-2 flakes and a seeded random
    scene, on the eager tracer and the wavefront;
  * a V-view gradient is the mean of the V one-view gradients;
  * a wavefront step builds one tree for its V views (the recorder's
    wf.bvh and views.rendered);
  * a 2-rank gloo fit with views is the one-device fit.
"""

import dataclasses
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.reference import views as rviews
from raytpu_torch.camera import View, posed_rays, scene_in_view, turntable
from raytpu_torch.config import RenderConfig
from raytpu_torch.grad import fit_scene, loss_and_grad_sharded
from raytpu_torch.kernels.wavefront import render_pixels_wavefront
from raytpu_torch.render import render_single
from raytpu_torch.scene import (LEAF_NAMES, SPD_AT, SPD_FROM, SPD_LIGHTS, SPD_SKY,
                                SPD_UP, SPHEREFLAKE_VIEW, build_scene,
                                default_scene, make_material, random_scene,
                                scene_from_leaves, scene_leaves,
                                sphereflake_scene, sphereflake_spheres)
from raytpu_torch.trace import render_image
from raytpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def world_flake(level: int, jitter: float = 0.0, seed: int = 0):
    """The SPD flake in its own world frame (z up), its lights and sky as
    sphereflake_scene has them, the centres jittered by seeded normal
    noise of `jitter`."""
    centres, radii, _ = sphereflake_spheres(level)
    centres = centres + jitter * np.random.default_rng(seed).normal(size=centres.shape)
    mat = make_material(0.5, (1.0, 0.9, 0.7), (1.0, 1.0, 1.0), opacity=0.999,
                        ior=1.5)
    col = np.full(3, 1.0 / np.sqrt(len(SPD_LIGHTS)))
    return build_scene([(c, r, mat) for c, r in zip(centres, radii)],
                       [(p, col) for p in SPD_LIGHTS], bg_matte=SPD_SKY,
                       bg_ior=1.0, bg_opacity=1.0, device="cpu")


def spd_cfg(size, alias, depth):
    return dataclasses.replace(SPHEREFLAKE_VIEW, width=size, height=size,
                               alias_factor=alias, max_depth=depth)


def ref_cfg(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "chunk_pixels"}


def ref_views(vs):
    return [(torch.tensor(v.rotation), torch.tensor(v.eye)) for v in vs]


def assert_pixel_contract(got, want):
    """The port's contract between two renders of one frame that round
    apart (tests/test_torch_cuda.py's): at most 1% of the pixels off by
    more than 1e-2 of the largest value (a grazing ray can take another
    sphere), and a mean |difference| under 1e-3 of it."""
    got, want = got.reshape(-1, 3).numpy(), want.reshape(-1, 3).numpy()
    assert np.isfinite(got).all()
    scale = float(np.abs(want).max())
    d = np.abs(got - want)
    assert (d.max(axis=-1) > 1e-2 * scale).mean() <= 0.01
    assert d.mean() < 1e-3 * scale


WF = {"chunk_rays": 512, "capacity_factor": 2.0}


def test_identity_view_is_the_reference_camera_bit_for_bit():
    scene = default_scene(device="cpu")
    cfg = RenderConfig(width=16, height=12, max_depth=3, alias_factor=2)
    ident = View.identity()
    assert torch.equal(render_image(scene, cfg),
                       render_image(scene, cfg, view=ident))
    assert torch.equal(render_pixels_wavefront(scene, cfg, **WF),
                       render_pixels_wavefront(scene, cfg, view=ident, **WF))
    assert torch.equal(render_single(scene, cfg, backend="wavefront"),
                       render_single(scene, cfg, backend="wavefront", view=ident))
    target = 1e-5 * torch.rand((cfg.num_pixels, 3),
                               generator=torch.Generator().manual_seed(1))
    for backend in ("torch", "wavefront"):
        loss, grads = loss_and_grad_sharded(scene, cfg, target, backend=backend,
                                            wf_opts=WF)
        vloss, vgrads = loss_and_grad_sharded(scene, cfg, target[None],
                                              backend=backend, wf_opts=WF,
                                              views=[ident])
        assert torch.equal(loss, vloss), backend
        for name, a, b in zip(LEAF_NAMES, scene_leaves(grads), scene_leaves(vgrads)):
            assert torch.equal(a, b), (backend, name)
        fitted, losses = fit_scene(scene, cfg, target, steps=2, backend=backend)
        vfitted, vlosses = fit_scene(scene, cfg, target[None], steps=2,
                                     backend=backend, views=[ident])
        assert losses == vlosses
        assert all(torch.equal(a, b) for a, b in zip(scene_leaves(fitted),
                                                      scene_leaves(vfitted)))


def test_posed_spd_view_of_the_world_flake_is_the_moved_scene():
    """sphereflake_scene moves the flake into the SPD camera's frame in
    float64 and rounds once; the world flake rounds its centres first and
    the posed rays round R^T d, so the two frames agree under the pixel
    contract, and not bit for bit: 8 of the 1,024 pixels (0.78%) read off
    by more than 1e-2 of the largest value, where rounding turns a ray of
    their depth-5 trees onto another sphere."""
    cfg = spd_cfg(32, 1, 5)
    spd = View.look_at(SPD_FROM, SPD_AT, SPD_UP)
    moved = render_image(sphereflake_scene(2, device="cpu"), cfg)
    for backend in ("torch", "wavefront"):
        posed = render_single(world_flake(2), cfg, backend=backend, view=spd)
        assert_pixel_contract(posed, moved)
    # The flake fills a good part of the frame.
    hit = (moved.reshape(-1, 3) - torch.tensor(SPD_SKY)).abs().amax(dim=1) > 1e-6
    assert 0.1 < float(hit.double().mean()) < 0.9


def test_scene_in_view_is_the_posed_frame():
    """The dense kernels' route (the scene moved into each view, rays from
    the origin) against the posed rays, on the eager tracer."""
    scene = world_flake(1, 0.02, seed=4)
    cfg = spd_cfg(24, 2, 3)
    spd = View.look_at(SPD_FROM, SPD_AT, SPD_UP)
    for view in turntable(spd, 3, SPD_UP, SPD_AT):
        assert_pixel_contract(render_image(scene_in_view(scene, view), cfg),
                              render_image(scene, cfg, view=view))
    # Only positions move, and the gradient flows back through the move.
    leaves = [t.detach().requires_grad_(True) for t in scene_leaves(scene)]
    moved = scene_in_view(scene_from_leaves(leaves), spd)
    assert moved.spheres.radius is leaves[1] and moved.bg.matte is leaves[8]
    torch.sum(moved.spheres.pos).backward()
    assert leaves[0].grad.abs().sum() > 0


def test_posed_rays_leave_the_eye_along_the_rotated_direction():
    view = turntable(View.look_at(SPD_FROM, SPD_AT, SPD_UP), 8, SPD_UP, SPD_AT)[3]
    d = torch.nn.functional.normalize(torch.randn(5, 3, generator=torch.Generator()
                                                  .manual_seed(0)), dim=1)
    origin, world = posed_rays(view, d)
    assert torch.equal(origin, torch.tensor(view.eye).expand(5, 3))
    want = d.double() @ torch.tensor(view.rotation).double()
    assert torch.allclose(world.double(), want, atol=1e-6)
    # The camera looks at the pivot: its back row points from it to the eye.
    back = torch.tensor(view.eye).double() / float(np.linalg.norm(view.eye))
    assert torch.allclose(torch.tensor(view.rotation[2]).double(), back, atol=1e-6)


def _cases():
    spd = View.look_at(SPD_FROM, SPD_AT, SPD_UP)
    look = View.look_at((0.0, 0.0, 10.0), (0.0, 0.0, -11.0), (0.0, 1.0, 0.0))
    small = RenderConfig(width=24, height=24, max_depth=3, alias_factor=2,
                         image_world_width=16.0, image_world_height=16.0)
    return {
        "flake1": (lambda: world_flake(1, 0.01, seed=11), spd_cfg(24, 2, 3),
                   turntable(spd, 3, SPD_UP, SPD_AT)),
        "flake2": (lambda: world_flake(2, 0.003, seed=12), spd_cfg(24, 1, 3),
                   turntable(spd, 3, SPD_UP, SPD_AT)),
        "random": (lambda: random_scene(12, num_lights=3, seed=2 ** 31 + 7,
                                        spread=10.0, device="cpu"),
                   small, turntable(look, 3, (0.0, 1.0, 0.0), (0.0, 0.0, -11.0))),
    }


CASES = _cases()


def _targets(scene, cfg, vs, seed):
    """Half of each view's own frame, jittered: a target that leaves a
    sizeable gradient on every kind of leaf."""
    g = torch.Generator().manual_seed(seed)
    return torch.stack([render_image(scene, cfg, view=v).reshape(-1, 3)
                        * (0.5 + torch.rand((cfg.num_pixels, 3), generator=g))
                        for v in vs])


@pytest.mark.parametrize("backend", ["torch", "wavefront"])
@pytest.mark.parametrize("case", list(CASES))
def test_three_view_step_matches_the_reference(case, backend):
    """Loss and gradient of a 3-view step, and the leaves after 2 Adam
    steps, against benchmark/reference/views.py.  The two round every
    operation alike but add the samples, the blocks and the views'
    gradients in other orders: the loss within 1e-5 of itself and each
    leaf's gradient within 1e-5 of its largest entry where that is
    significant (over 1e-6 of the largest leaf's), the contract of
    benchmark/tests/test_benchmark_reference.py (read: 1.1e-6 at most), and
    the leaves after the fit within
    1e-3 of Adam's step, lr, wherever the reference's gradient entry is
    over 1e-3 of its leaf's largest (a smaller one's sign, and so Adam's
    step, may turn on rounding)."""
    make, cfg, vs = CASES[case]
    scene = make()
    targets = _targets(scene, cfg, vs, seed=5)
    leaves = dict(zip(LEAF_NAMES, scene_leaves(scene)))
    rcfg = ref_cfg(cfg)
    loss, grads = loss_and_grad_sharded(scene, cfg, targets, backend=backend,
                                        wf_opts=WF, views=vs)
    rloss, rgrads = rviews.loss_and_grad(leaves, rcfg, targets, ref_views(vs),
                                         block_pixels=100)
    assert abs(float(loss) - float(rloss)) <= 1e-5 * float(rloss)
    top = max(float(g.abs().max()) for g in rgrads.values())
    for name, g in zip(LEAF_NAMES, scene_leaves(grads)):
        r = rgrads[name]
        scale = float(r.abs().max())
        if scale > 1e-6 * top:
            assert float((g - r).abs().max()) <= 1e-5 * scale, name
    lr = 1e-3
    fitted, losses = fit_scene(scene, cfg, targets, steps=2, learning_rate=lr,
                               backend=backend, wf_opts=WF, views=vs)
    rlosses, _, rparams = rviews.fit(leaves, rcfg, targets, ref_views(vs), 2, lr,
                                     block_pixels=100)
    assert np.allclose(losses, rlosses, rtol=1e-5, atol=0)
    for name, got in zip(LEAF_NAMES, scene_leaves(fitted)):
        r = rgrads[name]
        sure = r.abs() > 1e-3 * float(r.abs().max())
        diff = (got - rparams[name]).abs()[sure]
        assert diff.numel() == 0 or float(diff.max()) <= 1e-3 * lr, name


def test_a_multi_view_gradient_is_the_mean_of_one_view_gradients():
    make, cfg, vs = CASES["flake1"]
    scene = make()
    targets = _targets(scene, cfg, vs, seed=6)
    for backend in ("torch", "wavefront"):
        loss, grads = loss_and_grad_sharded(scene, cfg, targets, backend=backend,
                                            wf_opts=WF, views=vs)
        parts = [loss_and_grad_sharded(scene, cfg, t[None], backend=backend,
                                       wf_opts=WF, views=[v])
                 for v, t in zip(vs, targets)]
        assert math.isclose(float(loss), sum(float(p[0]) for p in parts) / 3,
                            rel_tol=1e-6)
        for i, g in enumerate(scene_leaves(grads)):
            mean = sum(scene_leaves(p[1])[i] for p in parts) / 3
            # The 1 / (3PV) and the sums round in another order.
            assert torch.allclose(g, mean, rtol=1e-5,
                                  atol=1e-6 * float(mean.abs().max())), (backend, i)


def test_a_step_builds_one_tree_for_its_views():
    """Two wavefront steps of 3 views under the profiler: two wf.bvh spans,
    six views.rendered and six views.view spans; the tree is built by the
    step alone, not by a view's frame."""
    make, cfg, vs = CASES["flake1"]
    scene = make()
    targets = _targets(scene, cfg, vs, seed=7)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        fit_scene(scene, cfg, targets, steps=2, backend="wavefront", views=vs,
                  wf_opts=WF)
    spans, counters = profiling.spans(), profiling.counters()
    profiling.reset()
    assert spans["wf.bvh"]["count"] == 2 and spans["fit.step"]["count"] == 2
    assert counters["views.rendered"] == 6 and spans["views.view"]["count"] == 6
    assert spans["wf.frame"]["count"] == 6


def test_views_need_a_target_a_view():
    make, cfg, vs = CASES["flake1"]
    with pytest.raises(ValueError, match="views"):
        loss_and_grad_sharded(make(), cfg, torch.zeros((2, cfg.num_pixels, 3)),
                              backend="torch", views=vs)


_WORKER = textwrap.dedent("""
    import sys, torch
    torch.set_num_threads(1)
    sys.path.insert(0, {root!r})
    sys.path.insert(0, {tests!r})
    from test_torch_views import CASES, _targets
    from raytpu_torch.grad import fit_scene
    from raytpu_torch.parallel import initialize_distributed, make_mesh
    from raytpu_torch.scene import scene_leaves
    rank = int(sys.argv[1])
    initialize_distributed({init!r}, 2, rank, backend="gloo")
    make, cfg, vs = CASES["flake1"]
    scene = make()
    targets = _targets(scene, cfg, vs, seed=8)
    fitted, losses = fit_scene(scene, cfg, targets, steps=2, learning_rate=1e-3,
                               mesh=make_mesh("cpu"), backend="wavefront",
                               wf_opts={wf!r}, views=vs)
    torch.save((losses, list(scene_leaves(fitted))), {out!r} + str(rank))
    torch.distributed.destroy_process_group()
""")


def test_a_two_rank_fit_with_views_is_the_one_device_fit(tmp_path):
    """Each rank its interleaved pixel set of every view, one all-reduce a
    step: the replicas agree bit for bit, and with the one-device fit the
    losses within 1e-5 and the leaves within 1e-3 of Adam's step wherever
    the gradient is significant (the ranks' shares add in another
    order, as in tests/test_torch_sharding.py)."""
    code = _WORKER.format(root=ROOT, tests=os.path.join(ROOT, "tests"),
                          init="file://" + str(tmp_path / "rendezvous"),
                          wf=WF, out=str(tmp_path / "rank"))
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(2)]
    for p in procs:
        out = p.communicate(timeout=240)[0]
        assert p.returncode == 0, out[-3000:]
    (l0, f0), (l1, f1) = (torch.load(tmp_path / f"rank{r}") for r in range(2))
    assert l0 == l1 and all(torch.equal(a, b) for a, b in zip(f0, f1))
    make, cfg, vs = CASES["flake1"]
    scene = make()
    targets = _targets(scene, cfg, vs, seed=8)
    _, grads = loss_and_grad_sharded(scene, cfg, targets, backend="wavefront",
                                     wf_opts=WF, views=vs)
    fitted, losses = fit_scene(scene, cfg, targets, steps=2, learning_rate=1e-3,
                               backend="wavefront", wf_opts=WF, views=vs)
    assert np.allclose(l0, losses, rtol=1e-5, atol=0)
    for a, b, g in zip(f0, scene_leaves(fitted), scene_leaves(grads)):
        diff = (a - b).abs()[g.abs() > 1e-3 * float(g.abs().max())]
        assert diff.numel() == 0 or float(diff.max()) <= 1e-6
