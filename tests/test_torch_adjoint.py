"""The backward kernel's hand-written adjoint, run on the CPU.

raytpu_torch/csrc/trace_bwd.cu compiled as plain C++ (g++ -x c++ -O2
-ffp-contract=off: every multiply and add rounded on its own, as nvcc's
-fmad=false builds the kernels) gives CPU entry points over the same
__host__ __device__ functions the kernels run: the forward's per-pixel walk,
the backward's walk (one tree a camera sample, the sphere loops once a
node and the adjoint from the saved selections), the reference instance's
per-pixel walk (the brute-force queries again in the adjoint), and one tree
node's forward and adjoint.  They are held against torch.autograd of the
plain version: the walks against grad_pixels_torch, one node against the
eager _trace_level; and the backward's walk against the reference's.

Contract: as tests/test_torch_grad.py.  The cotangent is zeroed on the
pixels (or rays) whose forward values differ by more than 1e-5*scale, at
most 1% of them; then every gradient leaf holds rtol 1e-3 where
|ref| > 1e-3*scale and atol 1e-6*scale elsewhere.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import raytpu_torch.config as tconfig
import raytpu_torch.scene as tscene
from raytpu_torch.kernels.trace_cuda import (grad_pixels_torch, grads_from_table,
                                             render_pixels_torch, scene_tables)
from raytpu_torch.scene import LEAF_NAMES, scene_leaves
from raytpu_torch.trace import _trace_level, camera_constants, camera_rays

torch.set_num_threads(2)

SOURCE = Path(__file__).resolve().parent.parent / "raytpu_torch" / "csrc" / "trace_bwd.cu"
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_TABLES = [_P, _I, _P, _I, _P]
_PIXELS = [_LL, _LL, _LL, _LL, _I, _I, _I] + [_F] * 8


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU harness of the CUDA sources")
    lib_path = tmp_path_factory.mktemp("adjoint") / "libtrace_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(lib_path), str(SOURCE)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.raytpu_trace_fwd_host.argtypes = _TABLES + [_P] + _PIXELS
    lib.raytpu_trace_bwd_host.argtypes = _TABLES + [_P, _P] + _PIXELS
    lib.raytpu_trace_bwd_ref_host.argtypes = _TABLES + [_P, _P] + _PIXELS
    lib.raytpu_node_host.argtypes = _TABLES + [_P, _I, _I] + [_P] * 8
    return lib


def _tables(scene):
    s, l, b = scene_tables(scene)
    return s, l, b, (s.data_ptr(), scene.spheres.count, l.data_ptr(),
                     scene.lights.count, b.data_ptr())


def _pixel_args(cfg, offset, count, stride):
    return (offset, count, stride, cfg.num_pixels, cfg.width, cfg.alias_factor,
            cfg.max_depth, *camera_constants(cfg))


def host_forward(lib, scene, cfg, offset=0, count=None, stride=1):
    count = cfg.num_pixels if count is None else count
    *keep, tables = _tables(scene)
    out = torch.zeros(3, count)
    lib.raytpu_trace_fwd_host(*tables, out.data_ptr(),
                              *_pixel_args(cfg, offset, count, stride))
    return out.T


def host_grad(lib, scene, cfg, g, offset=0, count=None, stride=1, walk="new"):
    """The gradient Scene by the backward's walk (walk="new") or the
    reference instance's (walk="ref")."""
    count = cfg.num_pixels if count is None else count
    *keep, tables = _tables(scene)
    n, nl = scene.spheres.count, scene.lights.count
    gout = torch.zeros(12 * n + 6 * nl + 5)
    g_t = g.T.contiguous()
    args = (*tables, g_t.data_ptr(), gout.data_ptr(),
            *_pixel_args(cfg, offset, count, stride))
    if walk == "ref":
        lib.raytpu_trace_bwd_ref_host(*args)
    else:
        lib.raytpu_trace_bwd_host(*args)
    return grads_from_table(gout, n, nl)


def masked_cotangent(port_fwd, ref_fwd, seed=0):
    port_fwd, ref_fwd = np.asarray(port_fwd), np.asarray(ref_fwd)
    scale = max(float(np.abs(ref_fwd).max()), 1e-12)
    bad = np.abs(port_fwd - ref_fwd).max(axis=-1) > 1e-5 * scale
    assert bad.mean() <= 0.01, f"{bad.sum()} of {bad.size} differ"
    g = np.random.default_rng(seed).uniform(0.5, 1.5, ref_fwd.shape)
    g = g.astype(np.float32)
    g[bad] = 0.0
    return torch.from_numpy(g)


def assert_close_masked(name, got, want, rtol=1e-3):
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    assert np.isfinite(got).all(), name
    scale = max(float(np.abs(want).max()), 1e-30)
    big = np.abs(want) > 1e-3 * scale
    np.testing.assert_allclose(got[big], want[big], rtol=rtol, atol=0,
                               err_msg=name)
    np.testing.assert_allclose(got[~big], want[~big], rtol=0, atol=1e-6 * scale,
                               err_msg=name)


CASES = {
    "default 32x16 d2": (lambda: tscene.default_scene(device="cpu"),
                         dict(width=32, height=16, max_depth=2, alias_factor=1), {}),
    "random8 32x16 d2": (lambda: tscene.random_scene(8, seed=3, device="cpu"),
                         dict(width=32, height=16, max_depth=2, alias_factor=1), {}),
    # At depth 4 and alias 2 one pixel differs by 6e-6*scale, under the
    # mask, and moves a small position coordinate by 4%: the measured
    # agreement is 2.6e-4 at depth 3 and 3e-6 at depth 4 with alias 1.
    "default 24x16 d3 a2 strided": (lambda: tscene.default_scene(device="cpu"),
                                    dict(width=24, height=16, max_depth=3, alias_factor=2),
                                    dict(offset=7, stride=2, count=200)),
    "default 24x16 d4": (lambda: tscene.default_scene(device="cpu"),
                         dict(width=24, height=16, max_depth=4, alias_factor=1), {}),
}


def _case_cotangent(lib, case):
    make, cfg_kw, sel = CASES[case]
    scene, cfg = make(), tconfig.RenderConfig(**cfg_kw)
    fwd = host_forward(lib, scene, cfg, **sel)
    plain = render_pixels_torch(scene, cfg, **sel)
    return scene, cfg, sel, masked_cotangent(fwd, plain)


@pytest.mark.parametrize("walk", ["new", "ref"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_matches_plain_gradient(host, case, walk):
    scene, cfg, sel, g = _case_cotangent(host, case)
    got = host_grad(host, scene, cfg, g, walk=walk, **sel)
    want = grad_pixels_torch(scene, cfg, g, **sel)
    for name, a, w in zip(LEAF_NAMES, scene_leaves(got), scene_leaves(want)):
        assert_close_masked(name, a, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_walk_matches_the_brute_force_walk(host, case):
    """The backward's walk (saved selections, one tree a sample, a medium's
    cotangent added where it is read) against the reference instance's
    walk: the same terms summed in another order, so every leaf within
    1e-5 x its scale."""
    scene, cfg, sel, g = _case_cotangent(host, case)
    got = host_grad(host, scene, cfg, g, walk="new", **sel)
    want = host_grad(host, scene, cfg, g, walk="ref", **sel)
    for name, a, w in zip(LEAF_NAMES, scene_leaves(got), scene_leaves(want)):
        a, w = a.numpy().astype(np.float64), w.numpy().astype(np.float64)
        scale = max(float(np.abs(w).max()), 1e-30)
        assert np.abs(a - w).max() <= 1e-5 * scale, name


def _seeded_states(scene, rng, count):
    """Camera rays and their live level-1 children (real states: rays
    inside spheres with their media), a seeded sample of `count`, with
    seeded intensities."""
    cfg = tconfig.RenderConfig(width=24, height=18, max_depth=1, alias_factor=1)
    d = camera_rays(cfg, 0, 0, device="cpu")
    b = d.shape[0]
    bg = scene.bg
    state0 = (torch.zeros(b, 3), d, torch.ones(b, 3),
              bg.matte.expand(b, 3), bg.ior.expand(b), bg.opacity.expand(b))
    with torch.no_grad():
        _, kids = _trace_level(scene, *state0, spawn=True)
    alive = kids[2].abs().amax(dim=1) > 0
    pool = [torch.cat([s0, k[alive]]) for s0, k in zip(state0, kids)]
    pick = torch.from_numpy(rng.choice(pool[0].shape[0], count, replace=False))
    o, d, i, m, ior, op = (t[pick].clone() for t in pool)
    i = i * torch.from_numpy(rng.uniform(0.5, 1.5, (count, 1)).astype(np.float32))
    return o, d, i, m, ior, op


def _run_nodes(lib, scene, flat, gw, dc):
    """The harness's node entry for every ray: (emission, children
    [refraction | reflection], spawned flags, state cotangents, scene
    gradient table)."""
    n_rays = flat.shape[0]
    *keep, tables = _tables(scene)
    out = dict(emission=torch.zeros(n_rays, 3), children=torch.zeros(n_rays, 2, 14),
               spawned=torch.zeros(n_rays, 2, dtype=torch.int32),
               dstate=torch.zeros(n_rays, 14),
               gout=torch.zeros(12 * scene.spheres.count + 6 * scene.lights.count + 5))
    for k in range(n_rays):
        lib.raytpu_node_host(*tables, flat[k].data_ptr(), 0, 1, gw[k].data_ptr(),
                             dc[k, 0].data_ptr(), dc[k, 1].data_ptr(),
                             out["emission"][k].data_ptr(),
                             out["children"][k].data_ptr(),
                             out["spawned"][k].data_ptr(),
                             out["dstate"][k].data_ptr(), out["gout"].data_ptr())
    return out


def test_node_adjoint_matches_autograd_of_trace_level(host):
    """One node's forward (emission and children) and hand-written adjoint
    against the eager _trace_level and torch.autograd, per ray, for seeded
    states and seeded cotangents of the emission and of both children.
    Absent children (and rays whose forward differs) take no cotangent."""
    scene = tscene.default_scene(device="cpu")
    rng = np.random.default_rng(7)
    n_rays = 96
    states = _seeded_states(scene, rng, n_rays)
    flat = torch.cat([states[0], states[1], states[2], states[3],
                      states[4][:, None], states[5][:, None]], dim=1).contiguous()

    leaves = [t.clone().requires_grad_(True) for t in scene_leaves(scene)]
    ad_states = [t.clone().requires_grad_(True) for t in states]
    em, kids = _trace_level(tscene.scene_from_leaves(leaves), *ad_states,
                            spawn=True)
    kid_flat = torch.cat([kids[0], kids[1], kids[2], kids[3], kids[4][:, None],
                          kids[5][:, None]], dim=1).reshape(2, n_rays, 14)
    kid_flat = kid_flat.transpose(0, 1)  # (ray, child, field)

    zeros = torch.zeros(n_rays, 2, 14)
    fwd = _run_nodes(host, scene, flat, torch.zeros(n_rays, 3), zeros)
    live = fwd["spawned"].bool()
    assert live.any(dim=0).all(), "both child kinds occur"
    same = (fwd["emission"] - em).abs().amax(dim=1) <= 1e-5 * em.abs().max()
    same &= ((kid_flat.detach() * live[..., None] - fwd["children"]).abs()
             .amax(dim=(1, 2)) <= 1e-5 * kid_flat.abs().max())
    assert (~same).sum() <= 1, f"{int((~same).sum())} rays differ"

    gw = torch.from_numpy(rng.uniform(0.5, 1.5, (n_rays, 3)).astype(np.float32))
    dc = torch.from_numpy(rng.uniform(-1.0, 1.0, (n_rays, 2, 14)).astype(np.float32))
    gw = (gw * same[:, None]).contiguous()
    dc = (dc * (live & same[:, None])[..., None]).contiguous()
    got = _run_nodes(host, scene, flat, gw, dc)

    total = torch.sum(em * gw) + torch.sum(kid_flat * dc)
    grads = torch.autograd.grad(total, leaves + ad_states, allow_unused=True)
    got_scene = grads_from_table(got["gout"], scene.spheres.count,
                                 scene.lights.count)
    for name, a, b in zip(LEAF_NAMES, scene_leaves(got_scene), grads[:11]):
        assert_close_masked(name, a, torch.zeros_like(a) if b is None else b)
    want = torch.cat([grads[11], grads[12], grads[13], grads[14],
                      grads[15][:, None], grads[16][:, None]], dim=1)
    for field, cols in (("origin", slice(0, 3)), ("direction", slice(3, 6)),
                        ("intensity", slice(6, 9)), ("medium matte", slice(9, 12)),
                        ("medium ior", slice(12, 13)),
                        ("medium opacity", slice(13, 14))):
        assert_close_masked(field, got["dstate"][:, cols], want[:, cols])



def test_walk_with_more_lights_than_a_bit_word(host):
    """40 lights (K2's shared table, many shadow tests a node): the
    backward's walk against the reference instance's walk (1e-5 x scale)
    and autograd under the gradient contract of tests/test_pallas.py:304-314
    (rtol 5e-2 where |ref| > 1e-3*scale): both walks are off autograd by
    the same 5.4e-3 on a light position here, the adjoint's float32 sums
    over 40 lights taken in another order than autograd's."""
    scene = tscene.random_scene(6, num_lights=40, seed=1, spread=5.0, device="cpu")
    cfg = tconfig.RenderConfig(width=24, height=16, max_depth=2, alias_factor=1)
    g = masked_cotangent(host_forward(host, scene, cfg),
                         render_pixels_torch(scene, cfg))
    got = host_grad(host, scene, cfg, g)
    ref = host_grad(host, scene, cfg, g, walk="ref")
    want = grad_pixels_torch(scene, cfg, g)
    for name, a, r, w in zip(LEAF_NAMES, scene_leaves(got), scene_leaves(ref),
                             scene_leaves(want)):
        assert_close_masked(name, a, w, rtol=5e-2)
        scale = max(float(r.abs().max()), 1e-30)
        assert float((a - r).abs().max()) <= 1e-5 * scale, name
