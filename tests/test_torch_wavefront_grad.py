"""The port's differentiable wavefront against raytpu's, on the CPU.

Inputs are made from a seed with numpy and handed to both packages.  What
is held, and how closely:

  * K4's plain version (`wf_level_bwd_torch`) against raytpu's level
    backward in the Pallas interpreter (`_wf_level_bwd_call(...,
    interpret=True)`) on one raytpu block of 8192 seeded states, children
    mapped from its per-tile [refraction | reflection] layout to the
    port's (2i, 2i+1).  The cotangents are zeroed on the rays whose
    forwards differ by more than 1e-5*scale (tests/test_torch_wavefront.py
    names how many: a grazing branch flips, and its gradient is
    near-singular); then tests/test_torch_grad.py's rule, rtol 1e-3 where
    |ref| > 1e-3*scale and atol 1e-6*scale elsewhere, holds d_state on the
    live rays and every scene table.
  * K4's CUDA source compiled by g++ as plain C++ (-ffp-contract=off, as
    nvcc's -fmad=false) against wf_level_bwd_torch under the same rule,
    the mask from the g++ build of K3 (which makes the same branch
    decisions), with exact zeros on dead rays.
  * K6's plain version (`uncompact_torch`) as the exact adjoint of
    `compact_torch` and equal to torch.autograd of it, and K6's CUDA source
    compiled by g++ bit for bit against it.
  * loss_and_grad_wavefront against raytpu's gradient (jax.vjp of the jnp
    tracer on a masked cotangent) and against the port's dense
    loss_and_grad (loss rtol 1e-5), every leaf within 2e-3*scale (the
    contract of tests/test_wavefront.py:196-219), the drop enforcement,
    the capacity ladder of fit_scene, a converging fit and the fit example.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_wavefront import SCENES, overflow_scenes, seeded_children, seeded_states

import raytpu.config as jconfig
import raytpu.scene as jscene
import raytpu.trace as jtrace
import raytpu_torch.config as tconfig
import raytpu_torch.grad as tgrad
import raytpu_torch.scene as tscene
from raytpu.kernels.trace_pallas import _scene_tables
from raytpu.kernels.wavefront import _wf_level_bwd_call, _wf_level_call
from raytpu_torch.examples import fit_scene as fit_example
from raytpu_torch.kernels import wavefront
from raytpu_torch.kernels.trace_cuda import grads_from_table, scene_tables
from raytpu_torch.kernels.wavefront import (N_STATE, compact, compact_torch,
                                            render_pixels_wavefront, uncompact,
                                            uncompact_torch, wf_level_bwd,
                                            wf_level_bwd_torch, wf_level_torch)
from raytpu_torch.render import DroppedRaysError
from raytpu_torch.scene import LEAF_NAMES, scene_leaves
from raytpu_torch.trace import render_pixels

torch.set_num_threads(2)

CSRC = Path(__file__).resolve().parent.parent / "raytpu_torch" / "csrc"
_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def assert_close_rule(name, got, want, rtol=1e-3):
    """tests/test_torch_grad.py's rule: rtol where |want| > 1e-3*scale,
    atol 1e-6*scale elsewhere."""
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    assert np.isfinite(got).all(), name
    scale = max(float(np.abs(want).max()), 1e-30)
    big = np.abs(want) > 1e-3 * scale
    np.testing.assert_allclose(got[big], want[big], rtol=rtol, atol=0, err_msg=name)
    np.testing.assert_allclose(got[~big], want[~big], rtol=0, atol=1e-6 * scale,
                               err_msg=name)


def assert_leaf_within(name, got, want, frac=2e-3):
    """tests/test_wavefront.py:215-219's contract for a whole gradient:
    max |got - want| <= frac * max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), name
    assert np.abs(got - want).max() <= frac * max(float(np.abs(want).max()), 1e-30), name


def rule_violations(got, want, rtol=1e-3):
    """How many elements break assert_close_rule's rule."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    tol = np.where(np.abs(want) > 1e-3 * scale, rtol * np.abs(want), 1e-6 * scale)
    return int((np.abs(got - want) > tol).sum())


def assert_level_grads(got, want, live, max_off):
    """(d_state, d_spheres, d_lights, d_bg) against the reference's: every
    table as the scene leaves under the rule, and the state rows (origin,
    direction, intensity) of the live rays with at most `max_off` elements
    off it: one ray's cotangent is not summed over rays, and the two sides
    round a near-cancelling sum each their own way."""
    off = sum(rule_violations(np.asarray(got[0])[rows][:, live],
                              np.asarray(want[0])[rows][:, live])
              for rows in (slice(0, 3), slice(3, 6), slice(6, 9)))
    assert off <= max_off, f"{off} state cotangents off the rule"
    n, nl = np.asarray(got[1]).shape[1], np.asarray(got[2]).shape[1]

    def leaves(t):
        flat = torch.cat([torch.from_numpy(np.array(x, np.float32)).reshape(-1)
                          for x in t[1:]])
        return scene_leaves(grads_from_table(flat, n, nl))

    for name, a, w in zip(LEAF_NAMES, leaves(got), leaves(want)):
        assert_close_rule(name, a, w)


def seeded_cotangents(rays, seed, bad):
    """em_ct ~ U(0.5, 1.5) (3, rays), ch_ct ~ U(-1, 1) (10, 2 rays) with a
    zero index row, both zero on the rays `bad` and their children."""
    rng = np.random.default_rng(seed)
    em_ct = rng.uniform(0.5, 1.5, (3, rays)).astype(np.float32)
    ch_ct = rng.uniform(-1.0, 1.0, (N_STATE, 2 * rays)).astype(np.float32)
    ch_ct[9] = 0.0
    em_ct[:, bad] = 0.0
    ch_ct[:, np.repeat(bad, 2)] = 0.0
    return em_ct, ch_ct


def rays_off(got, want, atol):
    return ~np.isclose(got, want, rtol=1e-5, atol=atol).all(axis=0)


def to_raytpu_children(kids, rays):
    """(10, 2R) with ray i's children at 2i, 2i+1 -> raytpu's one-tile
    [refraction block | reflection block] layout."""
    return kids.reshape(N_STATE, rays, 2).transpose(0, 2, 1).reshape(N_STATE, 2 * rays)


# (scene, spawn) -> state cotangents off the rule among the 8192 rays' 9
# fields against raytpu's level backward, measured on x86-64 (XLA:CPU
# contracts multiply-adds into FMAs) as 2 and 0, bounds +2.  On a scene
# past raytpu's unroll bound (random24, its gather path) a few light
# position sums differ by ~0.4% too: that scene is held against raytpu's
# jnp tracer below, where the forward mask can see such flips.
LEVEL_BWD_OFF = {("default", True): 4, ("default", False): 2}


@pytest.mark.parametrize("name,spawn", sorted(LEVEL_BWD_OFF))
def test_level_backward_matches_raytpu_level_backward(name, spawn):
    jmake, tmake = SCENES[name]
    js, ts = jmake(), tmake()
    st = seeded_states(ts, seed=3)
    rays = st.shape[1]
    state = torch.from_numpy(st)
    em, kids = wf_level_torch(ts, state, True)
    tables = _scene_tables(js)
    jstate = tuple(jnp.asarray(x) for x in st)
    jem, jkids = _wf_level_call(*tables, jstate, js.spheres.pos.shape[0],
                                js.lights.pos.shape[0], True, True)
    jem = np.stack([np.asarray(x) for x in jem])
    jkids = np.stack([np.asarray(x) for x in jkids])
    kids = to_raytpu_children(kids.numpy(), rays)
    live, jlive = (kids[6:9] != 0).any(axis=0), (jkids[6:9] != 0).any(axis=0)
    # raytpu zeroes a dead child's intensity only: compare live children.
    off = (live != jlive) | (live & jlive & rays_off(kids, jkids, 1e-6))
    bad = rays_off(em.numpy(), jem, 1e-12) | off.reshape(2, rays).any(axis=0)
    assert bad.sum() <= 60  # tests/test_torch_wavefront.py's bounds, 27 + 33
    em_ct, ch_ct = seeded_cotangents(rays, seed=4, bad=bad)
    # A dead child's cotangent is zero in the wavefront (the compaction
    # never keeps it); raytpu's dead child keeps its origin and direction,
    # so a cotangent there would reach its parent.
    ch_ct[:, ~(live & jlive).reshape(2, rays).T.reshape(-1)] = 0.0
    got = wf_level_bwd_torch(ts, state, torch.from_numpy(em_ct),
                             torch.from_numpy(ch_ct) if spawn else None, spawn)
    d_scene, d_lights, d_bg, d_state = _wf_level_bwd_call(
        *tables, jstate, tuple(jnp.asarray(x) for x in em_ct),
        tuple(jnp.asarray(x) for x in to_raytpu_children(ch_ct, rays)),
        js.spheres.pos.shape[0], js.lights.pos.shape[0], spawn, True)
    want = (np.stack([np.asarray(x) for x in d_state]), d_scene, d_lights,
            np.asarray(d_bg).ravel())
    dead = st[6:9].max(axis=0) == 0
    assert (got[0].numpy()[:, dead] == 0).all() and (got[0].numpy()[9] == 0).all()
    assert (np.asarray(want[0])[9] == 0).all()
    assert_level_grads([t.numpy() for t in got], want, ~dead & ~bad,
                       LEVEL_BWD_OFF[(name, spawn)])


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU harness of the CUDA sources")
    out = tmp_path_factory.mktemp("wf_bwd")
    libs = {}
    for name in ("wf_level", "wf_level_bwd", "wf_uncompact"):
        path = out / f"lib{name}_host.so"
        subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                        "-shared", "-fPIC", "-o", str(path), str(CSRC / f"{name}.cu")],
                       check=True, capture_output=True, text=True)
        libs[name] = ctypes.CDLL(str(path))
    # scene, n, lights, nl, bg, boxes, order, n_leaves, state, rays, spawn,
    # em, children, sel (null boxes: the brute-force loops)
    libs["wf_level"].raytpu_wf_level_host.argtypes = [_P, _I, _P, _I, _P, _P, _P, _I,
                                                      _P, _LL, _I, _P, _P, _P]
    # scene, n, lights, nl, bg, state, rays, spawn, em_ct, ch_ct, sel,
    # d_state, gout (null sel: the brute-force queries)
    libs["wf_level_bwd"].raytpu_wf_level_bwd_host.argtypes = [
        _P, _I, _P, _I, _P, _P, _LL, _I, _P, _P, _P, _P, _P]
    libs["wf_uncompact"].raytpu_wf_uncompact_host.argtypes = [_P, _LL, _P, _LL, _P]
    return libs


# (scene, spawn) -> state cotangents off the rule between the g++ build of
# wf_level_bwd.cu and the plain version (the hand-written adjoint against
# autograd): measured 0 on x86-64, bounds +2.
HOST_BWD_OFF = {("default", True): 2, ("random24", True): 2,
                ("random24", False): 2}


@pytest.mark.parametrize("name,spawn", sorted(HOST_BWD_OFF))
def test_level_backward_kernel_body_matches_plain_version(host, name, spawn):
    ts = SCENES[name][1]()
    state = torch.from_numpy(seeded_states(ts, seed=5))
    rays = state.shape[1]
    tables = scene_tables(ts)
    ptrs = (tables[0].data_ptr(), ts.spheres.count, tables[1].data_ptr(),
            ts.lights.count, tables[2].data_ptr())
    em = torch.zeros(3, rays)
    kids = torch.zeros(N_STATE, 2 * rays)
    host["wf_level"].raytpu_wf_level_host(*ptrs, None, None, 0, state.data_ptr(),
                                          rays, 1, em.data_ptr(), kids.data_ptr(),
                                          None)
    pem, pkids = wf_level_torch(ts, state, True)
    bad = (rays_off(em.numpy(), pem.numpy(), 0)
           | rays_off(kids.numpy(), pkids.numpy(), 1e-6).reshape(rays, 2).any(axis=1))
    assert bad.sum() <= 9  # tests/test_torch_wavefront.py's HOST_CASES: 6 + 3
    em_ct, ch_ct = (torch.from_numpy(x) for x in seeded_cotangents(rays, 6, bad))
    d_state = torch.full((N_STATE, rays), np.nan)
    gout = torch.zeros(12 * ts.spheres.count + 6 * ts.lights.count + 5)
    host["wf_level_bwd"].raytpu_wf_level_bwd_host(
        *ptrs, state.data_ptr(), rays, int(spawn), em_ct.data_ptr(),
        ch_ct.data_ptr() if spawn else None, None, d_state.data_ptr(),
        gout.data_ptr())
    n, nl = ts.spheres.count, ts.lights.count
    got = (d_state, gout[:12 * n].view(12, n), gout[12 * n:12 * n + 6 * nl].view(6, nl),
           gout[12 * n + 6 * nl:])
    want = wf_level_bwd_torch(ts, state, em_ct, ch_ct if spawn else None, spawn)
    dead = (state[6:9] == 0).all(dim=0).numpy()
    assert dead.any() and (d_state[:, dead] == 0).all() and (d_state[9] == 0).all()
    assert_level_grads([t.numpy() for t in got], [t.numpy() for t in want],
                       ~dead & ~bad, HOST_BWD_OFF[(name, spawn)])
    # The CPU dispatch of the wrapper is the plain version.
    via = wf_level_bwd(ts, state, em_ct, ch_ct if spawn else None, spawn)
    for a, b in zip(via, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("cap_kind", ["below", "above"])
def test_uncompact_is_the_adjoint_of_compact(host, cap_kind):
    kids, pid = seeded_children(seed=7)
    n_alive = int((kids[6:9] != 0).any(axis=0).sum())
    cap = n_alive - 555 if cap_kind == "below" else kids.shape[1]
    x = torch.from_numpy(kids).requires_grad_(True)
    state, out_pid, dropped, n_kept, src = compact_torch(
        x, torch.from_numpy(pid), cap, 600, return_src=True)
    n = int(n_kept)
    assert int(dropped) == max(n_alive - cap, 0)
    assert (src[n:] == -1).all() and (torch.diff(src[:n]) > 0).all()
    y = np.random.default_rng(8).normal(size=(N_STATE, cap)).astype(np.float32)
    y[9] = 0.0  # the index's cotangent is zero
    y = torch.from_numpy(y)
    back = uncompact_torch(y, src, kids.shape[1])
    lhs = float((state.detach().double() * y.double()).sum())
    rhs = float((torch.from_numpy(kids).double() * back.double()).sum())
    assert abs(lhs - rhs) <= 1e-12 * max(abs(lhs), 1.0)
    (auto,) = torch.autograd.grad(state, x, y)
    assert torch.equal(auto, back)
    assert (back[:, ~(kids[6:9] != 0).any(axis=0)] == 0).all()
    assert torch.equal(uncompact(y, src, kids.shape[1]), back)  # CPU: plain
    out = torch.full((N_STATE, kids.shape[1]), np.nan)
    host["wf_uncompact"].raytpu_wf_uncompact_host(y.data_ptr(), cap, src.data_ptr(),
                                                  kids.shape[1], out.data_ptr())
    assert torch.equal(out, back)
    with pytest.raises(TypeError):
        uncompact(y, src.long(), kids.shape[1])
    # Without return_src the compaction is as it was.
    plain = compact(torch.from_numpy(kids), torch.from_numpy(pid), cap, 600)
    assert len(plain) == 4 and all(torch.equal(a, b) for a, b in zip(
        plain, (state.detach(), out_pid, dropped, n_kept)))


def masked_gradient_case(js, ts, jcfg, tcfg, max_bad, probe=None):
    """The port's wavefront gradient of sum(img * g) (1024-ray chunks) and
    raytpu's (jax.vjp of the jnp tracer) for a seeded g zeroed on the
    pixels whose forwards differ by more than 1e-5*scale, at most
    `max_bad` of them.  `probe` (raytpu's scene, the port's) gives those
    forwards instead, for a scene whose own frame hides the terms its
    gradient sums."""
    gid = jnp.arange(jcfg.num_pixels, dtype=jnp.int32)
    fn = lambda s: jtrace.render_pixels(s, jcfg, gid)  # noqa: E731
    ref, vjp = jax.vjp(fn, js)
    leaves = [t.detach().requires_grad_(True) for t in scene_leaves(ts)]
    img = render_pixels_wavefront(tscene.scene_from_leaves(leaves), tcfg,
                                  chunk_rays=1024, capacity_factor=2)
    mine, theirs = img.detach().numpy(), np.asarray(ref)
    if probe is not None:
        mine = render_pixels_wavefront(probe[1], tcfg, chunk_rays=1024).numpy()
        # The forward of the program jax.vjp differentiates: XLA contracts
        # multiply-adds there as it does not in a jitted forward alone.
        theirs = np.asarray(jax.vjp(fn, probe[0])[0])
    bad = np.abs(mine - theirs).max(axis=1) > 1e-5 * np.abs(theirs).max()
    assert bad.sum() <= max_bad, f"{bad.sum()} pixels differ"
    g = np.random.default_rng(9).uniform(0.5, 1.5, theirs.shape).astype(np.float32)
    g[bad] = 0.0
    got = torch.autograd.grad(torch.sum(img * torch.from_numpy(g)), leaves,
                              allow_unused=True)
    want = jax.tree_util.tree_leaves(vjp(jnp.asarray(g))[0])
    return got, want


def half_opaque(js, ts, black: bool):
    """tests/test_wavefront.py:440-451's scene change: every opacity 0.5
    and, when `black`, every matte 0."""
    def change(sph, full, zeros):
        return dataclasses.replace(sph, opacity=full(sph.opacity, 0.5),
                                   matte=zeros(sph.matte) if black else sph.matte)

    return (dataclasses.replace(js, spheres=change(js.spheres, jnp.full_like,
                                                   jnp.zeros_like)),
            dataclasses.replace(ts, spheres=change(ts.spheres, torch.full_like,
                                                   torch.zeros_like)))


# case -> pixels of the 64x48 depth-3 frame whose forwards differ between
# the port and jitted raytpu by more than 1e-5*scale: measured on x86-64,
# bounds +25%.  The black-matte frame is black, so its mask comes from the
# same scene with its own mattes, whose frame shows every matte term the
# gradient sums, each sphere's in its own colour.
GRAD_CASES = {"random24": 89, "black_matte": 89}  # 71, 71


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_loss_and_grad_wavefront_matches_raytpu_and_the_dense_port(case):
    js = jscene.random_scene(24, num_lights=2, seed=5)
    ts = tscene.random_scene(24, num_lights=2, seed=5)
    probe = None
    if case == "black_matte":
        probe = half_opaque(js, ts, black=False)
        js, ts = half_opaque(js, ts, black=True)
    kw = dict(width=64, height=48, max_depth=3)
    got, want = masked_gradient_case(js, ts, jconfig.RenderConfig(alias_factor=1, **kw),
                                     tconfig.RenderConfig(alias_factor=1, **kw),
                                     GRAD_CASES[case], probe)
    for name, a, w in zip(LEAF_NAMES, got, want):
        assert_leaf_within(name, np.zeros(np.shape(w)) if a is None else a, w)

    # The port's own dense gradient, on two chunks of 1024-pixel windows.
    tcfg = tconfig.RenderConfig(alias_factor=2, **kw)
    assert wavefront.wavefront_sizes(tcfg, 1024, 2)[3] == 2
    target = torch.full((tcfg.num_pixels, 3), 1e-4)
    lw, gw, info = tgrad.loss_and_grad_wavefront(ts, tcfg, target, chunk_rays=1024,
                                                 return_info=True)
    lp, gp = tgrad.loss_and_grad(ts, tcfg, target, backend="torch")
    assert info["dropped"] == 0
    np.testing.assert_allclose(float(lw), float(lp), rtol=1e-5)
    for name, a, b in zip(LEAF_NAMES, scene_leaves(gw), scene_leaves(gp)):
        assert_leaf_within(name, a, b)
    if case == "black_matte":
        assert float(gw.spheres.matte.abs().max()) > 0


def test_drops_raise_and_fit_scene_climbs_the_ladder():
    _, ts = overflow_scenes()
    cfg = tconfig.RenderConfig(width=128, height=64, max_depth=1, alias_factor=1)
    target = torch.zeros(cfg.num_pixels, 3)
    with pytest.raises(DroppedRaysError):
        tgrad.loss_and_grad_wavefront(ts, cfg, target, chunk_rays=256, capacity_factor=1)
    _, _, info = tgrad.loss_and_grad_wavefront(ts, cfg, target, chunk_rays=256,
                                               capacity_factor=1, on_drop="ignore",
                                               return_info=True)
    assert info["dropped"] > 0
    # One SGD step at lr 1 moves each leaf by minus its gradient: the step
    # fit_scene kept is the one re-run at the escalated capacity.
    with pytest.warns(RuntimeWarning, match="auto-capacity"):
        fitted, losses = tgrad.fit_scene(
            ts, cfg, target, steps=1, backend="wavefront", wf_opts=dict(chunk_rays=256),
            optimizer=lambda p: torch.optim.SGD(p, lr=1.0))
    loss, grads, info = tgrad.loss_and_grad_wavefront(ts, cfg, target, chunk_rays=256,
                                                      capacity_factor=2.0,
                                                      return_info=True)
    assert info["dropped"] == 0 and losses == [float(loss)]
    for name, f, s, g in zip(LEAF_NAMES, scene_leaves(fitted), scene_leaves(ts),
                             scene_leaves(grads)):
        torch.testing.assert_close(f, s - g, rtol=0, atol=0, msg=name)
    with pytest.raises(DroppedRaysError):  # an explicit capacity is one attempt
        tgrad.fit_scene(ts, cfg, target, steps=1, backend="wavefront",
                        wf_opts=dict(chunk_rays=256, capacity_factor=1))


def test_fit_scene_wavefront_backend_converges():
    """tests/test_wavefront.py:397-425 on the port."""
    cfg = tconfig.RenderConfig(width=16, height=8, max_depth=1, alias_factor=1)
    truth = tscene.default_scene()
    target = render_pixels(truth, cfg, torch.arange(cfg.num_pixels))
    start = dataclasses.replace(truth, spheres=dataclasses.replace(
        truth.spheres, matte=truth.spheres.matte * 0.7))
    trainable = tscene.scene_from_leaves([n == "spheres.matte" for n in LEAF_NAMES])
    _, losses = tgrad.fit_scene(
        start, cfg, target, steps=8, backend="wavefront", trainable=trainable,
        optimizer=lambda p: torch.optim.Adam(p, lr=3e-2, eps=1e-16))
    assert losses[-1] < 0.5 * losses[0]


def test_fit_example_wavefront_on_the_cpu(capsys):
    res = fit_example.main(["--cpu", "--backend", "wavefront", "--steps", "3",
                            "--width", "16", "--height", "12", "--depth", "1"])
    assert len(res["losses"]) == 3 and res["losses"][-1] < res["start_loss"]
    assert res["fitted"].device.type == "cpu"
    assert "loss:" in capsys.readouterr().out


def test_training_backend_resolution():
    """"auto" trains through the wavefront on a CUDA scene from 640x480 3x3
    camera rays up (the crossover measured on the card); on the CPU it is
    the eager tracer, and an explicit backend is kept."""
    from raytpu_torch.render import _wf_wins_train

    ts = tscene.default_scene()
    big = tconfig.RenderConfig(width=640, height=480, max_depth=4)
    small = tconfig.RenderConfig(width=64, height=48, max_depth=4)
    assert _wf_wins_train(big) and not _wf_wins_train(small)
    assert tgrad.resolve_train_backend("auto", ts, big) == "torch"
    assert tgrad.resolve_train_backend("wavefront", ts, small) == "wavefront"
    with pytest.raises(ValueError):
        tgrad.resolve_train_backend("cuda", ts, small)  # a CPU scene
