"""The dense forward kernel's walk (one thread a camera sample, the sum in
the old order), run on the CPU.

raytpu_torch/csrc/trace_fwd.cu compiled as plain C++ (g++ -x c++ -O2
-ffp-contract=off: every multiply and add rounded on its own, as nvcc's
-fmad=false builds the kernels) gives two CPU entry points over the same
__host__ __device__ functions the kernels run: raytpu_trace_fwd_host, the
kernel's block walk (each round's sample slots traced by trace_slot, one
thread after another, then each pixel's samples added by sum_slots in the
order of s, as the kernel's two barriers order them), and
raytpu_trace_fwd_ref_host, the reference instance's per-pixel function
(pixel_forward: one thread walks its pixel's alias^2 trees in a row).

The two are held to each other bit for bit: the kernel sums the same
trees in the same order, so anything else is a fault in its indexing (the
blocks' pixel spans, the rounds where a pixel has more samples than a
block has threads, the clamp of the pixel set's tail).  Both are held to
the plain version, render_pixels_torch, under the forward contract of
tests/test_pallas.py:19-27 (outliers at 1e-2*scale <= 1%, mean abs diff
< 1e-3*scale).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import raytpu_torch.scene as tscene
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels.trace_cuda import render_pixels_torch, scene_tables
from raytpu_torch.trace import camera_constants

torch.set_num_threads(2)

SOURCE = Path(__file__).resolve().parent.parent / "raytpu_torch" / "csrc" / "trace_fwd.cu"
_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_ARGS = [_P, _I, _P, _I, _P, _P, _LL, _LL, _LL, _LL, _I, _I, _I] + [_F] * 8
_ENTRIES = {"kernel": "raytpu_trace_fwd_host", "reference": "raytpu_trace_fwd_ref_host"}

SCENES = {"default": lambda: tscene.default_scene(device="cpu"),
          "random32": lambda: tscene.random_scene(32, seed=3, device="cpu")}


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the CPU harness of the CUDA sources")
    lib_path = tmp_path_factory.mktemp("fwd") / "libtrace_fwd_host.so"
    subprocess.run([gxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                    "-shared", "-fPIC", "-o", str(lib_path), str(SOURCE)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in _ENTRIES.values():
        getattr(lib, name).argtypes = _ARGS
        getattr(lib, name).restype = None
    return lib


def host_forward(lib, which, scene, cfg, offset=0, count=None, stride=1):
    """(count, 3) through the kernel's walk or the reference's function."""
    count = cfg.num_pixels if count is None else count
    s, l, b = scene_tables(scene)
    out = torch.full((3, count), float("nan"))
    getattr(lib, _ENTRIES[which])(
        s.data_ptr(), scene.spheres.count, l.data_ptr(), scene.lights.count,
        b.data_ptr(), out.data_ptr(), offset, count, stride, cfg.num_pixels,
        cfg.width, cfg.alias_factor, cfg.max_depth, *camera_constants(cfg))
    return out.T


def same_bits(a, b):
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def contract(got, want):
    got, want = got.numpy().astype(np.float64), want.numpy().astype(np.float64)
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-12)
    d = np.abs(got - want)
    assert (d.max(axis=-1) > 1e-2 * scale).mean() <= 0.01
    assert d.mean() < 1e-3 * scale


@pytest.mark.parametrize("scene_name", sorted(SCENES))
@pytest.mark.parametrize("depth", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("alias", [1, 2, 3, 4])
def test_sample_walk_is_bit_identical_to_pixel_forward(host, scene_name, depth, alias):
    """The pixel set {5 + 3j : j < 301} of a 32x24 frame: an odd count whose
    blocks end mid-set (at alias 3, 14 pixels a block), and a tail past the
    last pixel that clamps to P-1."""
    scene = SCENES[scene_name]()
    cfg = RenderConfig(width=32, height=24, max_depth=depth, alias_factor=alias)
    sel = dict(offset=5, count=301, stride=3)
    got = host_forward(host, "kernel", scene, cfg, **sel)
    want = host_forward(host, "reference", scene, cfg, **sel)
    assert same_bits(got, want)
    assert same_bits(got[-40:], got[-1:].expand(40, 3))  # the clamped tail


@pytest.mark.parametrize("alias", [11, 12])
def test_rounds_past_a_block_keep_the_order(host, alias):
    """alias^2 = 121 fills one block with one pixel; 144 takes two rounds of
    128 sample slots, summed in order by the pixel's thread."""
    scene = tscene.default_scene(device="cpu")
    cfg = RenderConfig(width=8, height=6, max_depth=2, alias_factor=alias)
    sel = dict(offset=9, count=5, stride=7)
    got = host_forward(host, "kernel", scene, cfg, **sel)
    assert same_bits(got, host_forward(host, "reference", scene, cfg, **sel))
    contract(got, render_pixels_torch(scene, cfg, **sel))


@pytest.mark.parametrize("scene_name", sorted(SCENES))
@pytest.mark.parametrize("alias", [1, 2, 3])
def test_both_walks_hold_the_forward_contract(host, scene_name, alias):
    scene = SCENES[scene_name]()
    cfg = RenderConfig(width=32, height=24, max_depth=3, alias_factor=alias)
    want = render_pixels_torch(scene, cfg)
    for which in _ENTRIES:
        contract(host_forward(host, which, scene, cfg), want)


def test_empty_and_single_pixel_sets(host):
    scene = tscene.default_scene(device="cpu")
    cfg = RenderConfig(width=16, height=8, max_depth=2, alias_factor=3)
    assert host_forward(host, "kernel", scene, cfg, count=0).shape == (0, 3)
    one = host_forward(host, "kernel", scene, cfg, offset=127, count=1)
    assert same_bits(one, host_forward(host, "reference", scene, cfg, offset=127, count=1))
    contract(one, render_pixels_torch(scene, cfg, offset=127, count=1))
