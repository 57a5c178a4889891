"""The fused dense forward as a hand-written CUDA kernel (csrc/trace_fwd.cu),
its build and binding, and its plain PyTorch version.

Replaces raytpu/kernels/trace_pallas.py:_make_kernel.  The interface is the
TPU kernel's: `offset`, `count` and `stride` select the pixels
{offset + j*stride : j < count}, the tail clamps to P-1, and the result is
(count, 3) linear colour.

The kernel is built with nvcc for sm_90a at first use into
raytpu_torch/build/, keyed by a hash of its sources and flags, and loaded
with ctypes.  A scene on the CPU goes to the plain version; a scene on a
CUDA device goes to the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.trace import camera_constants, render_pixels

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

# -O3 with IEEE division and sqrt: never --use_fast_math, which
# approximates sqrtf and division.  -fmad=false keeps every multiply and add
# rounded on its own, as the plain version rounds them: with contraction,
# near-tangent hit, shadow and significance tests flip on ~3% of the pixels
# of a 32-sphere frame (measured on an H100), against 0% without it.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

MAX_DEPTH = 8         # kMaxDepth, the kernel's per-thread stack bound
MAX_SPHERES = 4096    # with MAX_LIGHTS, keeps the staged tables within
MAX_LIGHTS = 1024     # the 227 KB of shared memory a block may use


class CudaKernel:
    """One CUDA source file built into a shared library with a plain C
    entry point, and the count of its launches.

    `launches` is a plain integer that the wrapper adds one to where it
    launches the kernel, and nowhere else; a caller may reset it."""

    def __init__(self, name: str, source: str, symbol: str, argtypes):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None

    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.name}_{h.hexdigest()[:16]}.so"

    def build(self) -> float:
        """Compile the source with nvcc unless the library for this exact
        source is already built; returns the seconds spent compiling."""
        path = self.library_path()
        if path.exists():
            return 0.0
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME is None:
            raise RuntimeError(f"{self.name}: no CUDA toolkit found (nvcc), "
                               f"cannot build {self.source}")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [os.path.join(CUDA_HOME, "bin", "nvcc"), *NVCC_FLAGS,
               "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        self.build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"{self.name}: nvcc failed ({res.returncode}):\n"
                               f"{self.build_log}")
        os.replace(tmp, path)
        return seconds

    def function(self):
        """The bound C entry point, building the library first if needed."""
        if self._fn is None:
            self.build()
            lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

TRACE_FWD = CudaKernel(
    "trace_fwd", "trace_fwd.cu", "raytpu_trace_fwd",
    # scene, n, lights, nl, bg, out, offset, count, stride, total_pixels,
    # width, alias, max_depth, xstep, ystep, aspect, sub, half_w, half_h,
    # zoom, weight, device, stream
    [_p, _i, _p, _i, _p, _p, _ll, _ll, _ll, _ll, _i, _i, _i,
     _f, _f, _f, _f, _f, _f, _f, _f, _i, _p])


def scene_tables(scene):
    """The scene packed as the kernel reads it: spheres (12, N) rows pos
    xyz, radius, matte rgb, gloss rgb, opacity, ior; lights (6, L) rows pos
    xyz, colour rgb; background (5,) matte rgb, ior, opacity."""
    sph, lights, bg = scene.spheres, scene.lights, scene.bg
    spheres_tbl = torch.cat([sph.pos.T, sph.radius[None], sph.matte.T,
                             sph.gloss.T, sph.opacity[None], sph.ior[None]])
    lights_tbl = torch.cat([lights.pos.T, lights.col.T])
    bg_tbl = torch.cat([bg.matte, bg.ior[None], bg.opacity[None]])
    return (spheres_tbl.contiguous(), lights_tbl.contiguous(),
            bg_tbl.contiguous())


def _pixel_set(cfg: RenderConfig, offset: int, count, stride: int):
    count = cfg.num_pixels if count is None else int(count)
    if offset < 0 or stride < 1 or count < 0:
        raise ValueError(f"need offset >= 0, stride >= 1 and count >= 0, got "
                         f"offset={offset} stride={stride} count={count}")
    return int(offset), count, int(stride)


def render_pixels_torch(scene, cfg: RenderConfig, offset: int = 0,
                        count: int | None = None, stride: int = 1):
    """The plain version: the eager tracer on the pixel set
    {offset + j*stride : j < count} clamped to P-1 -> (count, 3)."""
    offset, count, stride = _pixel_set(cfg, offset, count, stride)
    gid = offset + torch.arange(count, dtype=torch.int64,
                                device=scene.device) * stride
    gid = torch.clamp(gid, max=cfg.num_pixels - 1)
    return render_pixels(scene, cfg, gid)


def _check_scene(scene, device):
    """Raise on any scene the kernel does not take."""
    n, nl = scene.spheres.count, scene.lights.count
    if not 1 <= n <= MAX_SPHERES:
        raise ValueError(f"the kernel takes 1..{MAX_SPHERES} spheres, got {n}")
    if not 0 <= nl <= MAX_LIGHTS:
        raise ValueError(f"the kernel takes 0..{MAX_LIGHTS} lights, got {nl}")
    shapes = {"spheres.pos": (n, 3), "spheres.radius": (n,),
              "spheres.matte": (n, 3), "spheres.gloss": (n, 3),
              "spheres.opacity": (n,), "spheres.ior": (n,),
              "lights.pos": (nl, 3), "lights.col": (nl, 3),
              "bg.matte": (3,), "bg.ior": (), "bg.opacity": ()}
    for key, shape in shapes.items():
        group, name = key.split(".")
        t = getattr(getattr(scene, group), name)
        if t.device != device:
            raise ValueError(f"{key} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{key} is {t.dtype}, the kernel takes float32")
        if tuple(t.shape) != shape:
            raise ValueError(f"{key} has shape {tuple(t.shape)}, expected {shape}")


def render_pixels_cuda(scene, cfg: RenderConfig, offset: int = 0,
                       count: int | None = None, stride: int = 1):
    """Render the pixels {offset + j*stride : j < count} -> (count, 3).

    On a CUDA scene this launches the kernel (or raises); on a CPU scene it
    runs the plain version."""
    device = scene.device
    if device.type == "cpu":
        return render_pixels_torch(scene, cfg, offset, count, stride)
    if device.type != "cuda":
        raise ValueError(f"render_pixels_cuda takes a CPU or CUDA scene, "
                         f"got {device}")
    offset, count, stride = _pixel_set(cfg, offset, count, stride)
    if cfg.max_depth > MAX_DEPTH:
        raise ValueError(f"the kernel's stack bounds max_depth at {MAX_DEPTH}, "
                         f"got {cfg.max_depth}")
    _check_scene(scene, device)
    out = torch.empty((3, count), dtype=torch.float32, device=device)
    if count == 0:
        return out.T
    spheres_tbl, lights_tbl, bg_tbl = scene_tables(scene)
    cam = camera_constants(cfg)
    fn = TRACE_FWD.function()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(spheres_tbl.data_ptr(), scene.spheres.count, lights_tbl.data_ptr(),
             scene.lights.count, bg_tbl.data_ptr(), out.data_ptr(),
             offset, count, stride, cfg.num_pixels, cfg.width,
             cfg.alias_factor, cfg.max_depth, *cam, device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"trace_fwd launch failed: CUDA error {err}")
    TRACE_FWD.launches += 1
    return out.T


def render_image_cuda(scene, cfg: RenderConfig):
    """(H, W, 3) frame through render_pixels_cuda."""
    return render_pixels_cuda(scene, cfg).reshape(cfg.height, cfg.width, 3)
