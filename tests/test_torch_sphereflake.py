"""Haines' SPD "balls" (the sphereflake) as the port builds it, on the CPU:

  * the recipe: 10, 91, 820 and 7,381 spheres at levels 1-4, every child
    touching its parent at a third of its radius, no two siblings
    overlapping, and the view's inverse putting the top sphere back at the
    SPD's origin;
  * the benchmark's configuration file, read as the benchmark reads it,
    is the builder's scene bit for bit at the builder's view;
  * a level-2 flake through the port's normal path (render_single,
    loss_and_grad at "auto") against the benchmark's plain reference
    under tests/../benchmark/tests/test_benchmark_reference.py's contract
    (every value within 1e-5 of the largest);
  * K3's walk (csrc/wf_level.cu built by g++ as plain C++, as
    tests/test_torch_bvh.py builds it) on the level-4 flake over a seeded
    sample of the SPD view's camera rays: closest, blocked and contain,
    and a whole level with its selections, bit for bit against the loops
    over every sphere;
  * the instance K3 and K4 launch, as their C entries choose it: in place
    at 7,381 spheres, staged at 256; and K4's slots counted under autograd.
"""

import ctypes
import dataclasses
import json
import shutil
import subprocess
from collections import defaultdict
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import inputs
from benchmark.reference import tracer
from raytpu_torch.config import RenderConfig
from raytpu_torch.grad import loss_and_grad, loss_and_grad_wavefront
from raytpu_torch.kernels import wavefront
from raytpu_torch.kernels.bvh import build_bvh
from raytpu_torch.kernels.trace_cuda import scene_tables
from raytpu_torch.kernels.wavefront import (IN_PLACE, N_STATE, level_instance,
                                            sel_rows, wavefront_sizes)
from raytpu_torch.render import render_single
from raytpu_torch.scene import (LEAF_NAMES, SPD_LIGHTS, SPHEREFLAKE_VIEW,
                                scene_leaves, spd_view, sphereflake_scene,
                                sphereflake_spheres)
from raytpu_torch.trace import camera_rays
from raytpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "raytpu_torch" / "csrc"
CONFIG = ROOT / "benchmark" / "configs" / "spd-balls4-512-d5.json"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
CLOSEST, BLOCKED, CONTAIN = 0, 1, 2


@pytest.fixture(scope="module")
def flake():
    return sphereflake_scene(4, device="cpu")


@pytest.mark.parametrize("level, count", [(1, 10), (2, 91), (3, 820), (4, 7381)])
def test_sphere_counts(level, count):
    centres, radii, parents = sphereflake_spheres(level)
    assert len(centres) == len(radii) == len(parents) == count
    assert sphereflake_scene(level, device="cpu").spheres.count == count


def test_children_touch_their_parents_at_a_third_of_their_radius(flake):
    """|c - p| = r_p + r_c, and r_c = r_p / 3, both to float32 rounding of
    the scene's values (coordinates up to ~3.8: a few ulps of 2.4e-7)."""
    _, _, parents = sphereflake_spheres(4)
    pos = flake.spheres.pos.double().numpy()
    rad = flake.spheres.radius.double().numpy()
    kid = np.nonzero(parents >= 0)[0]
    par = parents[kid]
    dist = np.sqrt(((pos[kid] - pos[par]) ** 2).sum(axis=1))
    np.testing.assert_allclose(dist, rad[par] + rad[kid], rtol=0, atol=2e-6)
    np.testing.assert_allclose(3 * rad[kid], rad[par], rtol=1e-7)
    assert np.bincount(par).max() == 9 and len(np.unique(par)) == 820


def test_no_two_siblings_overlap(flake):
    _, _, parents = sphereflake_spheres(4)
    pos = flake.spheres.pos.double().numpy()
    rad = flake.spheres.radius.double().numpy()
    families = defaultdict(list)
    for i, p in enumerate(parents):
        families[p].append(i)
    for kids in families.values():
        k = np.array(kids)
        gap = np.sqrt(((pos[k, None] - pos[None, k]) ** 2).sum(axis=-1))
        reach = rad[k, None] + rad[None, k]
        off = ~np.eye(len(k), dtype=bool)
        assert (gap[off] > reach[off]).all()


def test_the_inverse_view_puts_the_top_sphere_at_the_spd_origin(flake):
    rot, eye = spd_view()
    assert np.allclose(rot @ rot.T, np.eye(3)) and np.isclose(np.linalg.det(rot), 1.0)
    top = rot.T @ flake.spheres.pos[0].double().numpy() + eye
    assert np.abs(top).max() < 1e-6 and float(flake.spheres.radius[0]) == 0.5
    lights = flake.lights.pos.double().numpy() @ rot + eye
    np.testing.assert_allclose(lights, np.array(SPD_LIGHTS), atol=2e-6)
    # The eye at the origin looks down -z at the SPD's origin, up +y.
    assert np.allclose(rot @ (np.zeros(3) - eye) / np.linalg.norm(eye), [0, 0, -1])
    assert (rot @ np.array([0.0, 0.0, 1.0]))[1] > 0


def test_the_configuration_file_is_the_builders_scene(flake):
    config = json.loads(CONFIG.read_text())
    ours = inputs.scene_leaves(config, 2 ** 31 + 5, "cpu")
    assert tuple(ours) == LEAF_NAMES
    for name, want in zip(LEAF_NAMES, scene_leaves(flake)):
        assert torch.equal(ours[name].view(torch.int32), want.view(torch.int32)), name
    view = {f.name: getattr(SPHEREFLAKE_VIEW, f.name)
            for f in dataclasses.fields(RenderConfig) if f.name != "chunk_pixels"}
    assert config["render"] == view
    assert config["reduced"] == ["floor_polygon"]


def _reference_view(width, height, alias, depth):
    cfg = dataclasses.replace(SPHEREFLAKE_VIEW, width=width, height=height,
                              alias_factor=alias, max_depth=depth)
    return cfg, {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                 if f.name != "chunk_pixels"}


def test_level2_flake_through_the_normal_path_matches_the_reference():
    scene = sphereflake_scene(2, device="cpu")
    cfg, ref_cfg = _reference_view(32, 32, 1, 5)
    leaves = dict(zip(LEAF_NAMES, scene_leaves(scene)))
    port = render_single(scene, cfg).reshape(-1, 3)
    ref = tracer.render(leaves, ref_cfg, block_pixels=512)
    scale = float(port.abs().max())
    assert float((port - ref).abs().max()) <= 1e-5 * scale
    hit = (ref - torch.tensor([0.078, 0.361, 0.753])).abs().amax(dim=1) > 1e-6
    assert 0.1 < float(hit.double().mean()) < 0.9  # the flake fills the view
    target = 2 * float(port.mean()) * torch.rand(
        port.shape, generator=torch.Generator().manual_seed(23))
    loss, grads = loss_and_grad(scene, cfg, target)
    rloss, rgrads = tracer.loss_and_grad(leaves, ref_cfg, target, block_pixels=512)
    assert abs(float(loss) - float(rloss)) <= 1e-5 * float(rloss)
    for name, g in zip(LEAF_NAMES, scene_leaves(grads)):
        r = rgrads[name]
        assert float((g - r).abs().max()) <= 1e-5 * max(float(r.abs().max()), 1e-30), name


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """wf_level.cu and wf_level_bwd.cu built by g++ as plain C++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU harness of the CUDA sources")
    out = tmp_path_factory.mktemp("flake")
    libs = {}
    for name in ("wf_level", "wf_level_bwd"):
        path = out / f"lib{name}_host.so"
        subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                        "-shared", "-fPIC", "-o", str(path), str(CSRC / f"{name}.cu")],
                       check=True, capture_output=True, text=True)
        libs[name] = ctypes.CDLL(str(path))
    level = libs["wf_level"]
    level.raytpu_wf_level_host.argtypes = [_P, _I, _P, _I, _P, _P, _P, _I, _P, _LL,
                                           _I, _P, _P, _P]
    level.raytpu_wf_level_host.restype = None
    level.raytpu_bvh_query_host.argtypes = [_P, _I, _P, _P, _I, _I, _P, _LL, _P, _P]
    level.raytpu_bvh_query_host.restype = None
    level.raytpu_wf_level_instance.argtypes = [_I, _I, _I]
    level.raytpu_wf_level_instance.restype = _I
    bwd = libs["wf_level_bwd"].raytpu_wf_level_bwd_instance
    bwd.argtypes, bwd.restype = [_I, _I], _I
    return libs


def _query(host, spheres, tree, kind, inputs):
    """(out_i, out_f) of one query over inputs (6, count); tree None: the
    loops over every sphere."""
    inputs = torch.as_tensor(np.ascontiguousarray(inputs, np.float32))
    count = inputs.shape[1]
    out_i = torch.full((count,), -7, dtype=torch.int32)
    out_f = torch.full((count,), float("nan"))
    host["wf_level"].raytpu_bvh_query_host(
        spheres.data_ptr(), spheres.shape[1],
        tree.boxes.data_ptr() if tree else None,
        tree.order.data_ptr() if tree else None, tree.n_leaves if tree else 0,
        kind, inputs.data_ptr(), count, out_i.data_ptr(), out_f.data_ptr())
    return out_i, out_f


def _same_as_the_loops(host, spheres, tree, kind, inputs):
    got_i, got_f = _query(host, spheres, tree, kind, inputs)
    want_i, want_f = _query(host, spheres, None, kind, inputs)
    assert torch.equal(got_i, want_i), f"{int((got_i != want_i).sum())} answers differ"
    if kind == CLOSEST:
        assert torch.equal(got_f.view(torch.int32), want_f.view(torch.int32))
    return want_i, want_f


def _sampled_camera_rays(count, seed):
    """`count` of the SPD view's 512 x 512 x 9 camera rays, drawn without
    replacement from a seeded generator: (directions (count, 3), pixels)."""
    cfg = SPHEREFLAKE_VIEW
    rng = np.random.default_rng(seed)
    k = np.sort(rng.choice(cfg.rays_per_frame, count, replace=False))
    spp = cfg.samples_per_pixel
    gid, s = k // spp, k % spp
    d = torch.empty((count, 3))
    for i in range(cfg.alias_factor):
        for j in range(cfg.alias_factor):
            pick = s == i * cfg.alias_factor + j
            d[pick] = camera_rays(cfg, i, j, torch.tensor(gid[pick]))
    return d, gid


def test_the_walk_matches_the_loops_on_the_level4_flake(host, flake):
    """One in 576 of the SPD view's camera rays (4,096): their closest hits,
    the shadow segments from the hit points to the three lights, and the
    refraction probes 0.01 past them and just inside and outside the hit
    spheres, through the 4,096-leaf tree and through the loops."""
    spheres, lights, _ = scene_tables(flake)
    tree = build_bvh(spheres, lights)
    assert tree.n_leaves == 4096
    d, _ = _sampled_camera_rays(4096, seed=2 ** 31 + 23)
    rays = np.concatenate([np.zeros((3, 4096), np.float32), d.T.numpy()])
    hit, t = _same_as_the_loops(host, spheres, tree, CLOSEST, rays)
    found = hit.numpy() >= 0
    assert 0.2 < found.mean() < 0.6
    assert len(np.unique(hit.numpy()[found])) > 300  # many small spheres met
    point = (d.numpy() * t.numpy()[:, None])[found].T.astype(np.float32)
    light = lights[0:3].numpy()
    shadow = np.concatenate([np.repeat(point, 3, axis=1),
                             np.tile(light, point.shape[1])])
    blocked, _ = _same_as_the_loops(host, spheres, tree, BLOCKED, shadow)
    assert 0 < blocked.float().mean() < 1
    centre = spheres[0:3, hit.numpy()[found]].numpy()
    probes = [point + np.float32(0.01) * d.numpy()[found].T,
              centre + (point - centre) * np.float32(0.999),
              centre + (point - centre) * np.float32(1.001)]
    inside, _ = _same_as_the_loops(
        host, spheres, tree, CONTAIN,
        np.concatenate([np.concatenate(probes, axis=1).astype(np.float32),
                        np.zeros((3, 3 * point.shape[1]), np.float32)]))
    assert (inside >= 0).any() and (inside < 0).any()


def test_a_level_through_the_tree_is_bit_identical_on_the_flake(host, flake):
    """K3's per-ray function through the tree against the loops over every
    sphere on 4,096 sampled camera rays and their compacted children:
    emissions, children and selections, over two levels."""
    spheres, lights, bg = scene_tables(flake)
    tree = build_bvh(spheres, lights)
    d, _ = _sampled_camera_rays(4096, seed=2 ** 31 + 29)
    one, zero = torch.ones(4096), torch.zeros(4096)
    state = torch.stack([zero, zero, zero, *d.T, one, one, one, zero - 1]).contiguous()
    fn = host["wf_level"].raytpu_wf_level_host
    for _ in range(2):
        rays = state.shape[1]
        outs = []
        for boxes in (tree, None):
            em, kids = torch.empty((3, rays)), torch.empty((N_STATE, 2 * rays))
            sel = torch.empty((sel_rows(flake.lights.count), rays), dtype=torch.int32)
            fn(spheres.data_ptr(), flake.spheres.count, lights.data_ptr(),
               flake.lights.count, bg.data_ptr(),
               boxes.boxes.data_ptr() if boxes else None,
               boxes.order.data_ptr() if boxes else None,
               boxes.n_leaves if boxes else 0, state.data_ptr(), rays, 1,
               em.data_ptr(), kids.data_ptr(), sel.data_ptr())
            outs.append((em, kids, sel))
        for a, b in zip(*outs):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        kids = outs[0][1]
        state = kids[:, (kids[6:9] != 0).any(dim=0)].contiguous()
        assert state.shape[1] > 0


def test_the_instances_the_entries_choose(host, monkeypatch):
    """In place (K3 reads the scene table and the tree from global memory,
    K4 the table, adding every term to the global table) at the flake's
    7,381 spheres; everything staged in shared memory at 256.  The g++
    builds' entries answer in the card libraries' place."""
    for kernel, lib in ((wavefront.WF_LEVEL, host["wf_level"]),
                        (wavefront.WF_LEVEL_BWD, host["wf_level_bwd"])):
        monkeypatch.setattr(kernel, "function",
                            lambda name, lib=lib: getattr(lib, name))
    assert level_instance(7381, 3) == IN_PLACE
    assert level_instance(7381, 3, backward=True) == IN_PLACE
    assert level_instance(256, 4) == 1
    assert level_instance(256, 4, backward=True) == 1
    # Between them: K3 stages the table alone, K4 the table alone.
    assert level_instance(3000, 4) == 2
    assert level_instance(3000, 4, backward=True) == 2


def test_the_backward_counts_k4s_slots():
    """Under a profiler a one-chunk wavefront step counts as many K4 slots
    (wf.bwd_slots) as K3 slots, level for level; the in-place counters
    stay unset where no kernel runs (the CPU's plain versions)."""
    scene = sphereflake_scene(1, device="cpu")
    cfg = dataclasses.replace(SPHEREFLAKE_VIEW, width=32, height=32,
                              alias_factor=1, max_depth=2)
    assert wavefront_sizes(cfg, 8192, 2)[3] == 1
    profiling.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            loss_and_grad_wavefront(scene, cfg, torch.zeros(cfg.num_pixels, 3),
                                    chunk_rays=8192, capacity_factor=2)
        counted = profiling.counters()
    finally:
        profiling.reset()
    assert counted["wf.bwd_slots"] == counted["wf.slots"] > 0
    assert "wf.slots_inplace" not in counted and "wf.bwd_slots_inplace" not in counted
    assert "wf.bwd_slots" not in profiling.counters()  # off with the profiler off
