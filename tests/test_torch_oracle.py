"""The strict-semantics oracle of the port against raytpu's, bit for bit.

raytpu_torch.oracle (the tensor oracle, the plain version of the oracle
kernel) is held to raytpu.oracle (numpy) and raytpu_torch/csrc/oracle.cu's
host build to raytpu.native (native/rt_oracle.cpp through g++): the same
seeded scenes, every float32 bit equal and the NaN masks equal.  The host
build is oracle.cu compiled as plain C++ (g++ -x c++ -O2
-ffp-contract=off: every multiply and add rounded on its own, as nvcc's
-fmad=false builds the kernel) into raytpu_oracle_host, the kernels'
per-sample and per-pixel functions run pixel after pixel.  Its tone map at
400x300 cap 5 is docs/renders/golden_400x300_strict.ppm byte for byte.

No frame larger than 96x72 goes through a Python oracle (both take
seconds a frame there on a CPU).
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import raytpu.native as jnative
import raytpu.oracle as joracle
import raytpu.scene as jscene
from raytpu.config import RenderConfig as JConfig
import raytpu_torch.oracle as toracle
import raytpu_torch.scene as tscene
from raytpu_torch.config import RenderConfig
from raytpu_torch.image import read_ppm, tone_map
from raytpu_torch.kernels.trace_cuda import scene_tables
from raytpu_torch.native import render_native

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / "raytpu_torch" / "csrc" / "oracle.cu"
GOLDEN = ROOT / "docs" / "renders" / "golden_400x300_strict.ppm"
F = np.float32
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_HOST_ARGS = [_P, _I, _P, _I, _P, _I, _I, _F, _F, _F, _I, _I, _I, _I, _I, _LL,
              _LL, _P]

# (scene builder taking a package and its keyword arguments, frame, cap,
# fresnel_double): tests/test_native.py's three frames.
FRAMES = {
    "default 96x72 cap5": (lambda m, **kw: m.default_scene(bg_opacity=0.0, **kw),
                           dict(width=96, height=72), 5, False),
    "default 64x48 cap6 double": (
        lambda m, **kw: m.default_scene(bg_opacity=0.0, **kw),
        dict(width=64, height=48), 6, True),
    "random24 48x32 a2 cap5": (lambda m, **kw: m.random_scene(24, seed=7, **kw),
                               dict(width=48, height=32, alias_factor=2), 5,
                               False),
}


def assert_same_bits(got, want):
    """Every float32 bit equal, NaN masks equal (NaN payloads aside)."""
    got = np.ascontiguousarray(np.asarray(got, F))
    want = np.ascontiguousarray(np.asarray(want, F))
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32),
                                  want[~nan].view(np.int32))


def frame(name):
    build, kw, cap, double = FRAMES[name]
    return build(jscene), build(tscene, device="cpu"), kw, cap, double


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_render_oracle_matches_raytpu(name):
    js, ts, kw, cap, double = frame(name)
    want = joracle.render_oracle(js, JConfig(**kw), cap=cap, fresnel_double=double)
    got = toracle.render_oracle(ts, RenderConfig(**kw), cap=cap,
                                fresnel_double=double)
    assert got.device.type == "cpu"
    assert_same_bits(got.numpy(), want)


def test_camera_dirs_and_trace_on_a_flat_batch():
    """camera_dirs_oracle for every supersample of a 3x3 frame, and
    trace_oracle on a seeded batch of origins and directions at caps 1-6,
    with and without double Fresnel and a given background opacity."""
    kw = dict(width=40, height=30, alias_factor=3, zoom=-3.5,
              image_world_width=10.0, image_world_height=8.0)
    for i in range(3):
        for j in range(3):
            assert_same_bits(
                toracle.camera_dirs_oracle(RenderConfig(**kw), i, j, "cpu").numpy(),
                joracle.camera_dirs_oracle(JConfig(**kw), i, j))
    rng = np.random.default_rng(11)
    dirs = rng.normal(size=(2048, 3)).astype(F)
    dirs[:, 2] = -np.abs(dirs[:, 2])
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    origins = rng.uniform(-1.0, 1.0, (2048, 3)).astype(F)
    js, ts = jscene.random_scene(6, seed=5), tscene.random_scene(6, seed=5, device="cpu")
    for cap, double, bg in ((1, False, None), (2, True, 0.5), (4, False, 1.0),
                            (6, True, None)):
        want = joracle.trace_oracle(js, origins, dirs, cap=cap, bg_opacity=bg,
                                    fresnel_double=double)
        got = toracle.trace_oracle(ts, torch.tensor(origins), torch.tensor(dirs),
                                   cap=cap, bg_opacity=bg, fresnel_double=double)
        assert_same_bits(got.numpy(), want)


# The four quirks of tests/test_oracle_quirks.py, rebuilt on the port: each
# micro-scene's closed form, and raytpu's value bit for bit.

def _glass(pkg, ior, opacity=0.5, gloss=0.0):
    mat = pkg.make_material(gloss, (0.6, 0.5, 0.4), (1.0, 1.0, 1.0),
                            opacity=opacity, ior=ior)
    kw = {"device": "cpu"} if pkg is tscene else {}
    return pkg.build_scene([((0.0, 0.0, -5.0), 1.0, mat)],
                           [((0.0, 20.0, 0.0), (1.0, 1.0, 1.0))],
                           bg_opacity=0.0, **kw)


def _head_on(pkg, scene, cap):
    d = np.asarray([[0.0, 0.0, -1.0]], F)
    if pkg is tscene:
        return toracle.trace_oracle(scene, torch.zeros(3), torch.tensor(d),
                                    cap=cap, bg_opacity=0.0)[0].numpy()
    return joracle.trace_oracle(scene, np.zeros(3, F), d, cap=cap,
                                bg_opacity=0.0)[0]


def _matte_term(scene):
    """The port's stage-0 emission m for a head-on hit."""
    sc = toracle.OracleScene(scene, 0.0)
    found, _, point, normal, _, idx = toracle._calc_intersection(
        torch.zeros((1, 3)), torch.tensor([[0.0, 0.0, -1.0]]), sc)
    assert bool(found[0])
    calc = torch.ones((1, 3)) * sc.matte[idx]
    calc = sc.opacity[idx][:, None] * calc
    return (toracle._calculate_matte(point, normal, sc) * calc)[0].numpy()


def _quirk(ior, opacity, cap):
    """(the port's head-on colour, its m), held bit for bit to raytpu's."""
    ts, js = _glass(tscene, ior, opacity), _glass(jscene, ior, opacity)
    got = _head_on(tscene, ts, cap)
    assert_same_bits(got, _head_on(jscene, js, cap))
    return got, _matte_term(ts)


def test_quirk_truncation_doubles_the_matte_term():
    got, m = _quirk(1.0 + 1e-6, 0.5, cap=1)  # reflection colour insignificant
    np.testing.assert_allclose(got, 2 * m, rtol=1e-6)
    got, m = _quirk(1.55, 0.5, cap=1)  # Fresnel ~0.047: significant
    np.testing.assert_allclose(got, 4 * m, rtol=1e-6)


def test_quirk_stale_coloursum_on_an_insignificant_child():
    got, m = _quirk(1.0 + 1e-6, 0.999, cap=6)
    np.testing.assert_allclose(got, 2 * m, rtol=1e-6)


def test_quirk_total_internal_reflection_paints_nan():
    """A ray inside dense glass at 60 degrees to the exit normal: the TIR
    fall-through gives a NaN Fresnel factor, and the refracted child (no
    root beats the alignment floor, direction 0) misses and paints NaN."""
    s60, c60 = np.sin(np.deg2rad(60)), np.cos(np.deg2rad(60))
    d = np.asarray([[s60, 0.0, c60]], F)
    o = np.asarray([[0.0, 0.0, 1.0]], F) - F(0.5) * d
    outs = []
    for pkg, mod in ((tscene, toracle), (jscene, joracle)):
        mat = pkg.make_material(0.0, (0.1, 0.1, 0.1), (0, 0, 0), opacity=0.2,
                                ior=2.4)
        kw = {"device": "cpu"} if pkg is tscene else {}
        scene = pkg.build_scene([((0.0, 0.0, 0.0), 1.0, mat)],
                                [((0.0, 20.0, 5.0), (1.0, 1.0, 1.0))],
                                bg_opacity=0.0, **kw)
        sc = mod.OracleScene(scene, 0.0)
        if mod is toracle:
            out = mod._trace(torch.tensor(o), torch.tensor(d), torch.ones((1, 3)),
                             sc.matte[0].expand(1, 3), torch.full((1,), 2.4),
                             torch.full((1,), 0.2), 0, torch.zeros((1, 3)), sc,
                             6).numpy()
        else:
            out = mod._trace(o, d, np.ones((1, 3), F),
                             np.broadcast_to(sc.matte[0], (1, 3)).copy(),
                             np.full(1, F(2.4)), np.full(1, F(0.2)), 0,
                             np.zeros((1, 3), F), sc, 6)
        outs.append(out)
    assert np.isnan(outs[0]).any()
    assert_same_bits(outs[0], outs[1])


def test_quirk_miss_paints_the_medium_matte():
    outs = []
    for pkg in (tscene, jscene):
        mat = pkg.make_material(0.0, (1, 1, 1), (0, 0, 0), 1.0, 1.0)
        kw = {"device": "cpu"} if pkg is tscene else {}
        scene = pkg.build_scene([((50.0, 0.0, -50.0), 1.0, mat)],
                                [((0.0, 20.0, 0.0), (1, 1, 1))],
                                bg_matte=(0.2, 0.3, 0.4), bg_opacity=0.0, **kw)
        outs.append(_head_on(pkg, scene, cap=6))
    np.testing.assert_allclose(outs[0], [0.2, 0.3, 0.4], rtol=1e-6)
    assert_same_bits(outs[0], outs[1])


def test_render_native_refuses_a_cpu_scene():
    with pytest.raises(ValueError, match="render_oracle"):
        render_native(tscene.default_scene(device="cpu"),
                      RenderConfig(width=8, height=6))


# The host build of csrc/oracle.cu against raytpu.native.

@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU harness of the CUDA sources")
    lib_path = tmp_path_factory.mktemp("oracle") / "liboracle_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(lib_path), str(SOURCE)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib_path)).raytpu_oracle_host
    fn.argtypes = _HOST_ARGS
    fn.restype = None
    return fn


def host_render(fn, scene, cfg, cap=5, fresnel_double=False, offset=0,
                count=None, fma_mask=0, approx_mask=0):
    """(count, 3) through raytpu_oracle_host, with render_native's
    arguments."""
    count = cfg.num_pixels - offset if count is None else count
    s, l, b = scene_tables(scene)
    out = torch.full((count, 3), float("nan"))
    fn(s.data_ptr(), scene.spheres.count, l.data_ptr(), scene.lights.count,
       b.data_ptr(), cfg.width, cfg.height, cfg.zoom, cfg.image_world_width,
       cfg.image_world_height, cfg.alias_factor, cap, int(fresnel_double),
       fma_mask, approx_mask, offset, count, out.data_ptr())
    return out.numpy()


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_host_build_matches_raytpu_native(host, name):
    js, ts, kw, cap, double = frame(name)
    want = jnative.render_native(js, JConfig(**kw), cap=cap, fresnel_double=double)
    got = host_render(host, ts, RenderConfig(**kw), cap, double)
    assert_same_bits(got.reshape(want.shape), want)


def test_host_build_offset_count_and_world_plane(host):
    kw = dict(width=48, height=32, alias_factor=2, image_world_width=8.0,
              image_world_height=6.0)
    js, ts = jscene.default_scene(bg_opacity=0.0), tscene.default_scene(
        bg_opacity=0.0, device="cpu")
    want = jnative.render_native(js, JConfig(**kw), cap=5)
    got = host_render(host, ts, RenderConfig(**kw))
    assert_same_bits(got.reshape(want.shape), want)
    base = host_render(host, ts, dataclasses.replace(
        RenderConfig(**kw), image_world_width=16.0, image_world_height=12.0))
    assert not np.allclose(got, base)  # the plane reaches the camera
    kw = dict(width=32, height=16, alias_factor=1)
    want = jnative.render_native(js, JConfig(**kw), offset=100, count=64)
    assert_same_bits(host_render(host, ts, RenderConfig(**kw), offset=100,
                                 count=64), want)


@pytest.mark.parametrize("mask", [("fma", b) for b in range(5)]
                         + [("approx", b) for b in range(6)],
                         ids=lambda m: f"{m[0]}{m[1]}")
def test_host_build_masks_match_raytpu_native(host, mask):
    """Each experiment bit alone on random_scene(24, seed=7) (whose radii
    make every bit change some pixel): raytpu sets it process-wide (reset
    to 0 in a finally), the port passes it to the call."""
    kind, bit = mask
    kw = dict(width=48, height=32, alias_factor=2)
    js, ts = jscene.random_scene(24, seed=7), tscene.random_scene(24, seed=7,
                                                                  device="cpu")
    setter = jnative.set_fma_mask if kind == "fma" else jnative.set_approx_mask
    setter(1 << bit)
    try:
        want = jnative.render_native(js, JConfig(**kw))
    finally:
        setter(0)
    got = host_render(host, ts, RenderConfig(**kw), **{f"{kind}_mask": 1 << bit})
    assert_same_bits(got.reshape(want.shape), want)
    assert not np.array_equal(got, host_render(host, ts, RenderConfig(**kw)))


def test_host_build_reproduces_the_strict_golden(host):
    """docs/renders/golden_400x300_strict.ppm, byte for byte."""
    cfg = RenderConfig(width=400, height=300)
    img = host_render(host, tscene.default_scene(bg_opacity=0.0, device="cpu"),
                      cfg).reshape(300, 400, 3)
    np.testing.assert_array_equal(tone_map(img), read_ppm(GOLDEN))
