"""The level kernel's per-ray sphere culling (csrc/bvh.cuh, the tree of
raytpu_torch/kernels/bvh.py) against the brute-force loops, on the CPU.

The CUDA sources are compiled by g++ as plain C++ (-ffp-contract=off, as
nvcc's -fmad=false); host adds run in order, so everything here is held bit
for bit:

  * each query (closest hit with its t, shadow blocked, container) through
    the tree against the loops over every sphere, on seeded rays of the
    default scene, random_scene(24), random_scene(256, seed=3) and 3000
    spheres, and on adversarial ones: tangent rays, origins exactly on a
    surface, shadow origins on their own sphere, zero direction
    components, duplicated spheres (t ties, visited in either order),
    points on container and box boundaries, and rays grazing spheres of
    radius 0.01 at an extent of 250, where a test's rounding accepts rays
    that pass farther off the surface than a pad linear in the extent;
  * the level kernel (K3) through the tree against K3 with the loops:
    emissions, children and the selections `sel`;
  * the level backward (K4) from K3's `sel` against K4 re-running the
    loops: the state cotangents and every gradient table;
  * the tree's build: every sphere in exactly one leaf, every box holding
    its inflated spheres and its children.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_wavefront import seeded_states

import raytpu_torch.scene as tscene
from raytpu_torch.kernels.bvh import (PAD_ABS, PAD_REL, PAD_SQ, build_bvh,
                                      leaf_count, sphere_boxes, tree_over)
from raytpu_torch.kernels.trace_cuda import scene_tables
from raytpu_torch.kernels.wavefront import N_STATE, sel_rows

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parent.parent / "raytpu_torch" / "csrc"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
CLOSEST, BLOCKED, CONTAIN = 0, 1, 2

SCENES = {
    "default": tscene.default_scene,
    "random24": lambda: tscene.random_scene(24),
    "random256": lambda: tscene.random_scene(256, seed=3),
    "random3000": lambda: tscene.random_scene(3000, seed=3),
}


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU harness of the CUDA sources")
    out = tmp_path_factory.mktemp("bvh")
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
    level.raytpu_bvh_query_host.argtypes = [_P, _I, _P, _P, _I, _I, _P, _LL, _P, _P]
    libs["wf_level_bwd"].raytpu_wf_level_bwd_host.argtypes = [
        _P, _I, _P, _I, _P, _P, _LL, _I, _P, _P, _P, _P, _P]
    return libs


def query(host, spheres, tree, kind, inputs):
    """(out_i, out_f) of one query over inputs (6, count); tree None: the
    brute-force loops."""
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


def assert_query_matches(host, spheres, tree, kind, inputs):
    """The tree's answers equal the loops' bit for bit; returns the loops'
    indices (closest, contain) or flags (blocked)."""
    got_i, got_f = query(host, spheres, tree, kind, inputs)
    want_i, want_f = query(host, spheres, None, kind, inputs)
    assert torch.equal(got_i, want_i), f"{int((got_i != want_i).sum())} answers differ"
    if kind == CLOSEST:
        assert torch.equal(got_f.view(torch.int32), want_f.view(torch.int32))
    return want_i


def unit(v):
    return v / np.linalg.norm(v, axis=0, keepdims=True)


def surface_points(spheres, rng, count, scale=1.0):
    """Points c + scale * r * n on seeded spheres, float32, (3, count), and
    the sphere of each."""
    n = spheres.shape[1]
    idx = rng.integers(0, n, count)
    c = spheres[0:3, idx].numpy().astype(np.float64)
    r = spheres[3, idx].numpy().astype(np.float64)
    normal = unit(rng.normal(size=(3, count)))
    return (c + np.float32(scale) * r * normal).astype(np.float32), idx


def seeded_rays(spheres, lights, rng, count=3000):
    """Closest-hit rays (6, count): from the camera at 0 toward jittered
    sphere centres, from surface points in random directions, and from
    uniform points in the scene's bounds; a third unnormalized."""
    n = spheres.shape[1]
    k = count // 3
    c = spheres[0:3].numpy()
    r = spheres[3].numpy()
    target = c[:, rng.integers(0, n, k)] + rng.normal(size=(3, k)) * r.mean()
    cam = np.concatenate([np.zeros((3, k)), unit(target)])
    surf, _ = surface_points(spheres, rng, k)
    surf = np.concatenate([surf, unit(rng.normal(size=(3, k)))])
    lo, hi = c.min(axis=1, keepdims=True), c.max(axis=1, keepdims=True)
    m = count - 2 * k
    free = np.concatenate([lo + (hi - lo) * rng.uniform(size=(3, m)),
                           unit(rng.normal(size=(3, m)))])
    rays = np.concatenate([cam, surf, free], axis=1).astype(np.float32)
    rays[3:, ::3] *= rng.uniform(0.3, 2.0, (1, rays[:, ::3].shape[1])).astype(np.float32)
    return rays


def shadow_inputs(spheres, lights, rng, count=3000):
    """(point, light) pairs (6, count): points on sphere surfaces (the hit
    points shadow rays start from), lights of the scene or seeded ones."""
    p, _ = surface_points(spheres, rng, count)
    if lights.shape[1] > 0:
        light = lights[0:3, rng.integers(0, lights.shape[1], count)].numpy()
    else:
        light = rng.uniform(-60, 60, (3, count))
    return np.concatenate([p, light]).astype(np.float32)


def contain_inputs(spheres, rng, count=3000):
    """Probe points (6, count), the last three rows unused: just inside and
    outside surfaces, and uniform in the scene's bounds."""
    k = count // 3
    a, _ = surface_points(spheres, rng, k, 0.999)
    b, _ = surface_points(spheres, rng, k, 1.001)
    c = spheres[0:3].numpy()
    lo, hi = c.min(axis=1, keepdims=True), c.max(axis=1, keepdims=True)
    u = lo + (hi - lo) * rng.uniform(size=(3, count - 2 * k))
    pts = np.concatenate([a, b, u], axis=1).astype(np.float32)
    return np.concatenate([pts, np.zeros_like(pts)])


@pytest.mark.parametrize("name", sorted(SCENES))
def test_queries_match_brute_force_on_seeded_rays(host, name):
    spheres, lights, _ = scene_tables(SCENES[name]())
    tree = build_bvh(spheres, lights)
    rng = np.random.default_rng(11)
    hits = assert_query_matches(host, spheres, tree, CLOSEST,
                                seeded_rays(spheres, lights, rng))
    blocked = assert_query_matches(host, spheres, tree, BLOCKED,
                                   shadow_inputs(spheres, lights, rng))
    inside = assert_query_matches(host, spheres, tree, CONTAIN,
                                  contain_inputs(spheres, rng))
    # The cases exercise both answers of every query.
    assert (hits >= 0).any() and (hits < 0).any()
    assert blocked.any() and not blocked.all()
    assert (inside >= 0).any() and (inside < 0).any()


def tangent_rays(spheres, rng, count):
    """Rays tangent to seeded spheres (radius scaled by 1 and 1 +- 1e-6),
    starting 5 radii before the tangent point."""
    idx = rng.integers(0, spheres.shape[1], count)
    c = spheres[0:3, idx].numpy().astype(np.float64)
    r = spheres[3, idx].numpy().astype(np.float64)
    n = unit(rng.normal(size=(3, count)))
    u = unit(np.cross(n.T, rng.normal(size=(count, 3))).T)
    scale = rng.choice([1.0 - 1e-6, 1.0, 1.0 + 1e-6], count)
    p = c + scale * r * n
    return np.concatenate([p - 5 * r * u, u]).astype(np.float32)


@pytest.mark.parametrize("name", ["default", "random24", "random256"])
def test_queries_match_brute_force_on_adversarial_rays(host, name):
    spheres, lights, _ = scene_tables(SCENES[name]())
    tree = build_bvh(spheres, lights)
    rng = np.random.default_rng(12)
    k = 1000
    # Refraction origins exactly on a surface, in and out, some
    # unnormalized; rays along the axes from sphere centres and from the
    # extreme points of spheres and of their inflated boxes (zero direction
    # components, origins on box faces); the zero direction.
    on, _ = surface_points(spheres, rng, k)
    d = unit(rng.normal(size=(3, k))) * rng.choice([1.0, 1.7], (1, k))
    idx = rng.integers(0, spheres.shape[1], k)
    c = spheres[0:3, idx].numpy()
    r = spheres[3, idx].numpy()
    lo, hi = (t.numpy()[:, idx] for t in sphere_boxes(spheres, lights))
    axis = rng.integers(0, 3, k)
    sign = rng.choice([-1.0, 1.0], k)
    extreme = c.copy()
    extreme[axis, np.arange(k)] += sign * r
    face = c.copy()
    face[axis, np.arange(k)] = np.where(sign > 0, hi, lo)[axis, np.arange(k)]
    along = np.zeros((3, k))
    along[(axis + 1) % 3, np.arange(k)] = sign
    cases = [np.concatenate([on, d]), tangent_rays(spheres, rng, k),
             np.concatenate([c, along]), np.concatenate([extreme, along]),
             np.concatenate([face, along]), np.concatenate([face, -along]),
             np.concatenate([extreme, np.zeros((3, k))])]
    for rays in cases:
        assert_query_matches(host, spheres, tree, CLOSEST, rays)
    # Shadow origins on their own sphere, lit by every light; light and
    # point equal (gap 0); shadow rays along an axis.
    own = shadow_inputs(spheres, lights, rng, k)
    assert_query_matches(host, spheres, tree, BLOCKED, own)
    assert_query_matches(host, spheres, tree, BLOCKED,
                         np.concatenate([on, on]))
    assert_query_matches(host, spheres, tree, BLOCKED,
                         np.concatenate([extreme, extreme + 50 * along]))
    # Points on container boundaries: on the surface, at radius + 1e-6 (the
    # test's own epsilon), on the extreme points and the box faces.
    for scale in (1.0, 1.0 + 1e-6, 1.0 + 2e-6):
        pts, _ = surface_points(spheres, rng, k, scale)
        assert_query_matches(host, spheres, tree, CONTAIN,
                             np.concatenate([pts, pts]))
    for pts in (extreme, face, c):
        assert_query_matches(host, spheres, tree, CONTAIN,
                             np.concatenate([pts, pts]).astype(np.float32))


def small_far_scene(extent, seed):
    """Tables (spheres, lights) of random_scene(64)'s materials with the
    spheres moved to seeded points of [-extent, extent]^3 and shrunk to a
    radius of 0.005-0.01, and its lights moved into the same cube."""
    spheres, lights, _ = scene_tables(tscene.random_scene(64, seed=seed))
    rng = np.random.default_rng(seed)
    spheres, lights = spheres.clone(), lights.clone()
    spheres[0:3] = torch.from_numpy(rng.uniform(-extent, extent, (3, 64)).astype(np.float32))
    spheres[3] = torch.from_numpy(rng.uniform(0.005, 0.01, 64).astype(np.float32))
    lights[0:3] = torch.from_numpy(
        rng.uniform(-extent, extent, tuple(lights[0:3].shape)).astype(np.float32))
    return spheres, lights


def test_queries_match_brute_force_for_small_spheres_far_out(host):
    """Rays from seeded points of the cube passing 0.8e-3 to 1.4e-3 of the
    extent E = 250 off a sphere's centre, 20-70 radii: the closest-hit and
    shadow tests' rounding (~u E^2 / r off the surface) accepts some of
    them, farther off than PAD_REL (r + E) + PAD_ABS; the tree still tests
    every one of those spheres."""
    spheres, lights = small_far_scene(250.0, seed=9)
    tree = build_bvh(spheres, lights)
    pos, rad = spheres[0:3].double(), spheres[3].double()
    extent = max(float((pos.abs() + rad).max()), float(lights[0:3].abs().max()))
    rng = np.random.default_rng(14)
    m = 200_000
    idx = rng.integers(0, spheres.shape[1], m)
    c = pos[:, idx].numpy()
    o = rng.uniform(-extent, extent, (3, m))
    n = unit(np.cross((c - o).T, rng.normal(size=(m, 3))).T)
    graze = c + rng.uniform(0.8e-3, 1.4e-3, m) * extent * n
    rays = np.concatenate([o, unit(graze - o)]).astype(np.float32)
    hits = assert_query_matches(host, spheres, tree, CLOSEST, rays).numpy()
    # The accepted rays' distance off their sphere, from the float32 inputs.
    ok = hits >= 0
    p = rays[0:3, ok].astype(np.float64) - pos[:, hits[ok]].numpy()
    d = rays[3:6, ok].astype(np.float64)
    h = np.linalg.norm(p - (p * d).sum(0) / (d * d).sum(0) * d, axis=0)
    r = rad[hits[ok]].numpy()
    assert ok.sum() > 100 and (h - r > PAD_REL * (r + extent) + PAD_ABS).any()
    light = o + (graze - o) * rng.uniform(1.2, 3.0, (1, m))
    blocked = assert_query_matches(host, spheres, tree, BLOCKED,
                                   np.concatenate([o, light]))
    assert blocked.sum() > 100
    pts, _ = surface_points(spheres, rng, 3000)
    assert_query_matches(host, spheres, tree, CONTAIN, np.concatenate([pts, pts]))


@pytest.mark.parametrize("reverse", [False, True])
def test_ties_take_the_lowest_index(host, reverse):
    """Every sphere of random_scene(24) twice (index i and i + 24, equal t
    along every ray); with `reverse` the leaves hold them in reverse index
    order, so the higher index is tested first."""
    spheres, lights, _ = scene_tables(tscene.random_scene(24))
    twice = torch.cat([spheres, spheres], dim=1).contiguous()
    lo, hi = sphere_boxes(twice, lights)
    n = twice.shape[1]
    order = torch.arange(n - 1, -1, -1) if reverse else torch.arange(n)
    tree = tree_over(lo, hi, order)
    rng = np.random.default_rng(13)
    hits = assert_query_matches(host, twice, tree, CLOSEST,
                                seeded_rays(twice, lights, rng))
    assert (hits >= 0).any() and (hits < 24).all()
    inside = assert_query_matches(host, twice, tree, CONTAIN,
                                  contain_inputs(twice, rng))
    assert (inside >= 0).any() and (inside < 24).all()
    assert_query_matches(host, twice, tree, BLOCKED, shadow_inputs(twice, lights, rng))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_tree_build(name):
    spheres, lights, _ = scene_tables(SCENES[name]())
    tree = build_bvh(spheres, lights)
    n, nl = spheres.shape[1], tree.n_leaves
    assert nl == leaf_count(n) and nl & (nl - 1) == 0
    assert tree.boxes.shape == (6, 2 * nl) and tree.order.dtype == torch.int32
    # Every sphere in exactly one leaf, every leaf one or two spheres.
    assert torch.equal(torch.sort(tree.order.long()).values, torch.arange(n))
    starts = torch.arange(nl + 1) * n // nl
    sizes = starts[1:] - starts[:-1]
    assert int(sizes.min()) >= 1 and int(sizes.max()) <= 2
    # Each leaf box holds its spheres inflated by the pad; each node its
    # children.
    pos, rad = spheres[0:3], spheres[3]
    extent = max(float((pos.abs() + rad).max()), float(lights[0:3].abs().max()))
    pad = (PAD_REL * (rad + extent) + PAD_ABS
           + torch.sqrt(rad.double() ** 2 + PAD_SQ * extent ** 2).float() - rad)
    leaf = torch.repeat_interleave(torch.arange(nl), sizes)
    o = tree.order.long()
    box = tree.boxes[:, nl + leaf]
    assert (box[0:3] <= pos[:, o] - rad[o] - 0.99 * pad[o]).all()
    assert (box[3:6] >= pos[:, o] + rad[o] + 0.99 * pad[o]).all()
    k = torch.arange(1, nl)
    for child in (2 * k, 2 * k + 1):
        assert (tree.boxes[0:3, k] <= tree.boxes[0:3, child]).all()
        assert (tree.boxes[3:6, k] >= tree.boxes[3:6, child]).all()


def host_level(host, ts, st, spawn, tree):
    """The g++ build of K3 over the state: (em, children, sel); tree None:
    the brute-force loops."""
    rays = st.shape[1]
    spheres, lights, bg = scene_tables(ts)
    em = torch.full((3, rays), float("nan"))
    kids = torch.full((N_STATE, 2 * rays), float("nan"))
    sel = torch.full((sel_rows(ts.lights.count), rays), -7, dtype=torch.int32)
    host["wf_level"].raytpu_wf_level_host(
        spheres.data_ptr(), ts.spheres.count, lights.data_ptr(), ts.lights.count,
        bg.data_ptr(), tree.boxes.data_ptr() if tree else None,
        tree.order.data_ptr() if tree else None, tree.n_leaves if tree else 0,
        st.data_ptr(), rays, int(spawn), em.data_ptr(),
        kids.data_ptr() if spawn else None, sel.data_ptr())
    return em, kids if spawn else None, sel


def bits(t):
    return t.view(torch.int32)


@pytest.mark.parametrize("name,spawn", [("default", True), ("random24", True),
                                        ("random24", False), ("random256", True),
                                        ("random3000", True)])
def test_level_through_the_tree_is_bit_identical(host, name, spawn):
    ts = SCENES[name]()
    rays = 2048 if name == "random3000" else 8192
    st = torch.from_numpy(seeded_states(ts, seed=2)[:, :rays].copy())
    spheres, lights, _ = scene_tables(ts)
    em, kids, sel = host_level(host, ts, st, spawn, build_bvh(spheres, lights))
    rem, rkids, rsel = host_level(host, ts, st, spawn, None)
    assert torch.equal(bits(em), bits(rem))
    if spawn:
        assert torch.equal(bits(kids), bits(rkids))
    assert torch.equal(sel, rsel)
    dead = (st[6:9] == 0).all(dim=0)
    assert dead.any() and (sel[0:2, dead] == -1).all() and (sel[2:, dead] == 0).all()
    live = ~dead
    assert (sel[0, live] >= 0).any() and (sel[0, live] < 0).any()
    assert (sel[2, live] != 0).any()
    if spawn:
        assert (sel[1, live] >= 0).any()


@pytest.mark.parametrize("name,spawn", [("default", True), ("random24", True),
                                        ("random24", False), ("random256", True)])
def test_level_backward_from_sel_is_bit_identical(host, name, spawn):
    ts = SCENES[name]()
    st = torch.from_numpy(seeded_states(ts, seed=5))
    rays = st.shape[1]
    spheres, lights, bg = scene_tables(ts)
    _, _, sel = host_level(host, ts, st, spawn, build_bvh(spheres, lights))
    rng = np.random.default_rng(6)
    em_ct = torch.from_numpy(rng.uniform(0.5, 1.5, (3, rays)).astype(np.float32))
    ch_ct = torch.from_numpy(rng.uniform(-1, 1, (N_STATE, 2 * rays)).astype(np.float32))
    ch_ct[9] = 0.0
    n, nl = ts.spheres.count, ts.lights.count
    out = []
    for saved in (sel, None):
        d_state = torch.full((N_STATE, rays), float("nan"))
        gout = torch.zeros(12 * n + 6 * nl + 5)
        host["wf_level_bwd"].raytpu_wf_level_bwd_host(
            spheres.data_ptr(), n, lights.data_ptr(), nl, bg.data_ptr(),
            st.data_ptr(), rays, int(spawn), em_ct.data_ptr(),
            ch_ct.data_ptr() if spawn else None,
            saved.data_ptr() if saved is not None else None, d_state.data_ptr(),
            gout.data_ptr())
        out.append((d_state, gout))
    (d_state, gout), (rd_state, rgout) = out
    assert torch.isfinite(d_state).all() and (gout != 0).any()
    assert torch.equal(bits(d_state), bits(rd_state))
    assert torch.equal(bits(gout), bits(rgout))
