"""The port's wavefront tracer against raytpu's, on the CPU.

Inputs are made from a seed with numpy and handed to both packages.  What
is held, and how closely:

  * K3's plain version (`wf_level_torch`) against raytpu's level kernel in
    the Pallas interpreter (`_wf_level_call(..., interpret=True)`), with
    the children mapped from its per-tile [refraction | reflection] layout
    to the port's (2i, 2i+1).  Outside a named count of rays, every value
    holds rtol 1e-5; the rays in the count flip a branch (a grazing hit or
    shadow, a significance cutoff) because XLA contracts multiply-adds
    into FMAs and the interpreter's large-N gather path rounds its own
    way.  The same states through raytpu.trace._trace_level, the
    reference's jnp level body, agree with the port on all but a few rays.
  * K3's CUDA source compiled by g++ as plain C++ (-ffp-contract=off, as
    nvcc's -fmad=false) against wf_level_torch: rtol 1e-5 outside a named
    count of rays (the matte sum over lights adds in another order).
  * K5's plain version (`compact_torch`) against raytpu's `_compact`: the
    kept live children per pixel id, sorted (raytpu's sort is unstable
    within a pixel), the exact drop and kept counts.
  * The whole wavefront against the port's dense eager tracer under
    tests/test_wavefront.py's contract, its drop counter against raytpu's
    global compaction on the overflow scene, its windows and eager_sort,
    and the drop reporting of tests/test_drop_reporting.py.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytpu.config as jconfig
import raytpu.scene as jscene
import raytpu.trace as jtrace
import raytpu_torch.cli as tcli
import raytpu_torch.config as tconfig
import raytpu_torch.scene as tscene
from raytpu.kernels.trace_pallas import _scene_tables
from raytpu.kernels.wavefront import _compact, _wf_level_call, render_pixels_wavefront
from raytpu_torch.image import read_ppm, tone_map
from raytpu_torch.kernels.trace_cuda import scene_tables
from raytpu_torch.kernels.wavefront import (N_STATE, camera_state, compact,
                                            compact_torch, wavefront_sizes,
                                            wf_level, wf_level_torch)
from raytpu_torch.kernels.wavefront import (
    render_pixels_wavefront as t_render_pixels_wavefront)
from raytpu_torch.render import DroppedRaysError, render_single
from raytpu_torch.trace import render_image

torch.set_num_threads(2)

SOURCE = Path(__file__).resolve().parent.parent / "raytpu_torch" / "csrc" / "wf_level.cu"

SCENES = {
    "default": (jscene.default_scene, tscene.default_scene),
    "random24": (lambda: jscene.random_scene(24, num_lights=2),
                 lambda: tscene.random_scene(24, num_lights=2)),
    "random256": (lambda: jscene.random_scene(256, seed=3),
                  lambda: tscene.random_scene(256, seed=3)),
}


def seeded_states(scene, seed, rays=8192):
    """(10, rays) float32 numpy states: camera rays of a 128x64 frame and
    the live children of its first level, a seeded pick of `rays` of them,
    intensities scaled by U(0.2, 1.5), 10% set exactly to zero and 5% scaled
    below 1e-3, and 20% of the medium indices drawn from {-1, 0..N-1}."""
    rng = np.random.default_rng(seed)
    cfg = tconfig.RenderConfig(width=128, height=64, max_depth=1, alias_factor=1)
    zero = torch.zeros(cfg.num_pixels, dtype=torch.int64)
    s0 = camera_state(cfg, torch.arange(cfg.num_pixels), zero, zero,
                      torch.ones(cfg.num_pixels, dtype=torch.bool))
    _, kids = wf_level_torch(scene, s0, True)
    alive = (kids[6:9] != 0).any(dim=0)
    pool = torch.cat([s0, kids[:, alive]], dim=1).numpy()
    st = pool[:, rng.choice(pool.shape[1], rays, replace=False)].copy()
    st[6:9] *= rng.uniform(0.2, 1.5, (1, rays)).astype(np.float32)
    u = rng.uniform(size=rays)
    st[6:9, u < 0.1] = 0.0
    st[6:9, (u >= 0.1) & (u < 0.15)] *= np.float32(5e-4)
    v = rng.uniform(size=rays)
    st[9, v < 0.2] = rng.integers(-1, scene.spheres.count, int((v < 0.2).sum()))
    return st.astype(np.float32)


def rays_off(got, want, atol):
    """Rays (columns) where any field is off rtol 1e-5."""
    return ~np.isclose(got, want, rtol=1e-5, atol=atol).all(axis=0)


# (scene, spawn) -> rays off rtol 1e-5 of the 8192 against raytpu's level
# kernel in the interpreter, (emissions, children), measured on x86-64
# (21/26 and 134/307), bounds +25%.
LEVEL_CASES = {("default", True): (27, 33), ("default", False): (27, 0),
               ("random24", True): (168, 384), ("random24", False): (168, 0)}


@pytest.mark.parametrize("name,spawn", sorted(LEVEL_CASES))
def test_level_matches_raytpu_level_kernel(name, spawn):
    jmake, tmake = SCENES[name]
    js, ts = jmake(), tmake()
    st = seeded_states(ts, seed=1)
    rays = st.shape[1]
    em, kids = wf_level_torch(ts, torch.from_numpy(st), spawn)
    em = em.numpy()
    jem, jkids = _wf_level_call(*_scene_tables(js), tuple(jnp.asarray(x) for x in st),
                                js.spheres.pos.shape[0], js.lights.pos.shape[0],
                                spawn, True)
    jem = np.stack([np.asarray(x) for x in jem])
    max_em, max_kids = LEVEL_CASES[(name, spawn)]
    assert rays_off(em, jem, 1e-12).sum() <= max_em
    assert (em[:, st[6:9].max(axis=0) == 0] == 0).all()

    # The reference's own jnp level body on the same states, media gathered.
    idx = st[9].astype(np.int64)
    tbl = np.asarray(_scene_tables(js)[0])
    bgv = np.asarray(_scene_tables(js)[2]).ravel()
    inside, safe = idx >= 0, np.maximum(idx, 0)
    matte = np.where(inside[:, None], tbl[4:7, safe].T, bgv[:3])
    ior = np.where(inside, tbl[11, safe], bgv[3])
    opacity = np.where(inside, tbl[10, safe], bgv[4])
    jnp_em, _ = jtrace._trace_level(js, *(jnp.asarray(x) for x in (
        st[0:3].T, st[3:6].T, st[6:9].T, matte, ior, opacity)), spawn=spawn)
    assert rays_off(em, np.asarray(jnp_em).T, 1e-12).sum() <= 4

    if not spawn:
        assert kids is None and jkids is None
        return
    kids = kids.numpy()
    jkids = np.stack([np.asarray(x) for x in jkids])
    jkids = jkids.reshape(N_STATE, 2, rays).transpose(0, 2, 1).reshape(N_STATE, 2 * rays)
    live, jlive = (kids[6:9] != 0).any(axis=0), (jkids[6:9] != 0).any(axis=0)
    assert live.any()
    assert (live != jlive).sum() <= 3
    assert (kids[:, ~live] == 0).all()          # dead children: ten zeros
    assert (jkids[6:9, ~jlive] == 0).all()      # raytpu zeroes their intensity
    both = live & jlive
    assert rays_off(kids[:, both], jkids[:, both], 1e-6).sum() <= max_kids


# (scene) -> rays off rtol 1e-5 of the 8192, (emissions, children), between
# the g++ build of wf_level.cu and wf_level_torch: measured 4/0, 4/1, 10/14.
HOST_CASES = {"default": (6, 2), "random24": (6, 3), "random256": (13, 18)}


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU harness of the CUDA source")
    lib_path = tmp_path_factory.mktemp("wf_level") / "libwf_level_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(lib_path), str(SOURCE)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    # scene, n, lights, nl, bg, boxes, order, n_leaves, state, rays, spawn,
    # em, children, sel (null boxes: the brute-force loops)
    lib.raytpu_wf_level_host.argtypes = [p, i, p, i, p, p, p, i, p, ll, i, p, p, p]
    return lib


@pytest.mark.parametrize("name", sorted(HOST_CASES))
def test_level_kernel_body_matches_plain_version(host, name):
    ts = SCENES[name][1]()
    st = torch.from_numpy(seeded_states(ts, seed=2))
    rays = st.shape[1]
    spheres, lights, bg = scene_tables(ts)
    em = torch.full((3, rays), np.nan)
    kids = torch.full((N_STATE, 2 * rays), np.nan)
    host.raytpu_wf_level_host(spheres.data_ptr(), ts.spheres.count,
                              lights.data_ptr(), ts.lights.count, bg.data_ptr(),
                              None, None, 0, st.data_ptr(), rays, 1, em.data_ptr(),
                              kids.data_ptr(), None)
    want_em, want_kids = wf_level_torch(ts, st, True)
    max_em, max_kids = HOST_CASES[name]
    assert torch.isfinite(em).all() and torch.isfinite(kids).all()
    assert rays_off(em.numpy(), want_em.numpy(), 0).sum() <= max_em
    assert rays_off(kids.numpy(), want_kids.numpy(), 1e-6).sum() <= max_kids
    live = (kids[6:9] != 0).any(dim=0)
    assert (kids[:, ~live] == 0).all()
    assert (live != (want_kids[6:9] != 0).any(dim=0)).sum() <= max_kids


def seeded_children(seed, parents=4096, slots=600):
    """(10, 2*parents) children with 40% dead (intensity exactly zero) and
    some with one zero channel, and sorted parent pids in [0, slots)."""
    rng = np.random.default_rng(seed)
    kids = rng.normal(size=(N_STATE, 2 * parents)).astype(np.float32)
    kids[6:9] = np.abs(kids[6:9])
    u = rng.uniform(size=2 * parents)
    kids[6:9, u < 0.4] = 0.0
    kids[6, (u >= 0.4) & (u < 0.5)] = 0.0
    pid = np.sort(rng.integers(0, slots, parents)).astype(np.int32)
    return kids, pid


def kept_rows(state, pid, n):
    rows = np.concatenate([pid[:n, None].astype(np.float64),
                           state[:, :n].T.astype(np.float64)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.parametrize("cap_kind", ["below", "above"])
def test_compaction_matches_raytpu(cap_kind):
    kids, pid = seeded_children(seed=5)
    n_alive = int((kids[6:9] != 0).any(axis=0).sum())
    cap = n_alive - 777 if cap_kind == "below" else kids.shape[1]
    state, out_pid, dropped, n_kept = compact_torch(
        torch.from_numpy(kids), torch.from_numpy(pid), cap, 600)
    jstate, jpid, jdropped, jkept = _compact(
        tuple(jnp.asarray(k) for k in kids), jnp.asarray(np.repeat(pid, 2)), cap)
    assert int(dropped) == int(jdropped) == max(n_alive - cap, 0)
    assert int(n_kept) == int(jkept) == min(n_alive, cap)
    n = int(n_kept)
    state, out_pid = state.numpy(), out_pid.numpy()
    jstate = np.stack([np.asarray(x) for x in jstate])
    jpid = np.asarray(jpid)
    # The same pids in the same order; the live children per pid, sorted.
    # raytpu's unstable sort may keep other children of the pid that the
    # capacity cuts, so that pid's are held by count.
    np.testing.assert_array_equal(out_pid[:n], jpid[:n])
    last = out_pid[n - 1] if cap_kind == "below" else -1
    whole = out_pid[:n] != last
    np.testing.assert_array_equal(kept_rows(state[:, :n][:, whole], out_pid[:n][whole], int(whole.sum())),
                                  kept_rows(jstate[:, :n][:, whole], jpid[:n][whole], int(whole.sum())))
    assert (np.diff(out_pid[:n]) >= 0).all()
    assert (state[:, n:] == 0).all()
    np.testing.assert_array_equal(out_pid[n:], np.arange(n, cap) % 600)


def test_compaction_is_stable_and_dispatches_on_the_cpu():
    kids, pid = seeded_children(seed=6, parents=64, slots=10)
    kt, pt = torch.from_numpy(kids), torch.from_numpy(pid)
    state, out_pid, dropped, n_kept = compact(kt, pt, 50, 10)
    alive = np.flatnonzero((kids[6:9] != 0).any(axis=0))
    np.testing.assert_array_equal(state[:, :50].numpy(), kids[:, alive[:50]])
    np.testing.assert_array_equal(out_pid[:50].numpy(), pid[alive[:50] // 2])
    assert int(dropped) == len(alive) - 50 and int(n_kept) == 50
    with pytest.raises(ValueError):
        compact(kt, pt[:-1], 50, 10)
    with pytest.raises(TypeError):
        compact(kt, pt.long(), 50, 10)
    with pytest.raises(TypeError):
        wf_level(tscene.default_scene(), kt.double(), True)


def assert_wavefront_contract(out, ref, frac_tol=0.005):
    """tests/test_wavefront.py's contract: outliers at 1e-3*scale <= 0.5%,
    mean abs diff < 1e-4*scale."""
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    scale = max(float(ref.max()), 1e-30)
    d = np.abs(out - ref)
    assert (d.max(axis=-1) > 1e-3 * scale).mean() <= frac_tol
    assert d.mean() < 1e-4 * scale


@pytest.mark.parametrize("case", ["default_d3_a2_multichunk", "random24_d4"])
def test_wavefront_matches_dense_eager(case):
    scene, cfg = {
        "default_d3_a2_multichunk": (
            tscene.default_scene(),
            tconfig.RenderConfig(width=64, height=48, max_depth=3, alias_factor=2)),
        "random24_d4": (
            tscene.random_scene(24, num_lights=2),
            tconfig.RenderConfig(width=64, height=48, max_depth=4, alias_factor=1)),
    }[case]
    if case.endswith("multichunk"):
        assert wavefront_sizes(cfg, 4096, 2)[3] > 1
    out, info = t_render_pixels_wavefront(scene, cfg, chunk_rays=4096,
                                          capacity_factor=2, return_info=True)
    assert int(info["dropped"]) == 0
    assert_wavefront_contract(out, render_image(scene, cfg).reshape(-1, 3))


def overflow_scenes():
    """tests/test_wavefront.py:85-102's frame-filling transparent sphere,
    for (raytpu, the port): every camera ray spawns two live children."""
    out = []
    for pkg in (jscene, tscene):
        mat = pkg.make_material(0.3, (0.2, 0.4, 0.6), (0.9, 0.9, 0.9),
                                opacity=0.0, ior=1.5)
        out.append(pkg.build_scene(
            sphere_specs=[((0.0, 0.0, -10.0), 9.9, mat)],
            light_specs=[((10.0, 30.0, 10.0), (0.5, 0.5, 0.5))]))
    return out


@pytest.mark.parametrize("depth", [1, 2])
def test_drop_count_matches_raytpu_global_compaction(depth):
    js, ts = overflow_scenes()
    kw = dict(width=128, height=64, max_depth=depth, alias_factor=1)
    _, info = t_render_pixels_wavefront(ts, tconfig.RenderConfig(**kw),
                                        chunk_rays=256, capacity_factor=1,
                                        return_info=True)
    _, jinfo = render_pixels_wavefront(js, jconfig.RenderConfig(**kw),
                                       chunk_rays=256, capacity_factor=1,
                                       interpret=True, return_info=True,
                                       compact_mode="global")
    got, want = int(info["dropped"]), int(jinfo["dropped"])
    assert got > 0 and want > 0
    if depth == 1:  # one compaction: the same kept count, the same drops
        assert got == want


def test_eager_sort_and_pixel_windows():
    scene = tscene.default_scene()
    cfg = tconfig.RenderConfig(width=64, height=48, max_depth=3, alias_factor=1)
    full = t_render_pixels_wavefront(scene, cfg, chunk_rays=4096)
    lazy = t_render_pixels_wavefront(scene, cfg, chunk_rays=4096, eager_sort=False)
    scale = float(full.abs().max())
    assert float((full - lazy).abs().max()) < 1e-4 * scale
    for offset, count, stride in ((0, 1000, 1), (5, 700, 3), (3000, 200, 1)):
        part = t_render_pixels_wavefront(scene, cfg, chunk_rays=2048,
                                         offset=offset, count=count,
                                         shard_stride=stride)
        ids = torch.clamp(offset + torch.arange(count) * stride,
                          max=cfg.num_pixels - 1)
        torch.testing.assert_close(part, full[ids], rtol=0, atol=1e-6 * scale)


OVERFLOW = dict(chunk_rays=256, capacity_factor=1)


def test_drop_reporting():
    _, ts = overflow_scenes()
    cfg = tconfig.RenderConfig(width=128, height=64, max_depth=2, alias_factor=1)
    with pytest.warns(RuntimeWarning, match="dropped .* live rays"):
        img, info = render_single(ts, cfg, backend="wavefront", wf_opts=OVERFLOW,
                                  return_info=True)
    assert info["dropped"] > 0 and img.shape == (64, 128, 3)
    with pytest.raises(DroppedRaysError):
        render_single(ts, cfg, backend="wavefront", wf_opts=OVERFLOW,
                      on_drop="raise")
    with pytest.warns(RuntimeWarning, match="auto-capacity"):
        img, info = render_single(ts, cfg, backend="wavefront",
                                  wf_opts=dict(chunk_rays=256),
                                  return_info=True, on_drop="raise")
    assert info["dropped"] == 0 and info["wf_opts"]["capacity_factor"] > 1


def test_cli_wavefront(tmp_path, capsys):
    from raytpu_torch.scene_io import save_scene

    _, ts = overflow_scenes()
    scene_path = str(tmp_path / "overflow.json")
    save_scene(ts, scene_path)
    rc = tcli.main(["--width", "128", "--height", "64", "--max-depth", "2",
                    "--alias-factor", "1", "--backend", "wavefront", "--cpu",
                    "--scene-file", scene_path, "--chunk-rays", "256",
                    "--capacity-factor", "1", "--strict-drops"])
    assert rc == 3
    assert "dropped" in capsys.readouterr().err

    out = str(tmp_path / "wf.ppm")
    small = ["--width", "40", "--height", "24", "--max-depth", "2",
             "--alias-factor", "2", "--cpu"]
    assert tcli.main(small + ["--backend", "wavefront", "--chunk-rays", "1024",
                              "--strict-drops", "-o", out]) == 0
    cfg = tconfig.RenderConfig(width=40, height=24, max_depth=2, alias_factor=2)
    img = render_single(tscene.default_scene(), cfg, backend="wavefront",
                        wf_opts=dict(chunk_rays=1024))
    np.testing.assert_array_equal(read_ppm(out), tone_map(img.numpy()))
