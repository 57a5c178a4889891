"""The fused dense forward and backward as hand-written CUDA kernels
(csrc/trace_fwd.cu, csrc/trace_bwd.cu), their build and binding, their
plain PyTorch versions, and the autograd Function that pairs them.

They replace raytpu/kernels/trace_pallas.py:_make_kernel and
_make_bwd_kernel.  The interface is the TPU kernels': `offset`, `count` and
`stride` select the pixels {offset + j*stride : j < count}, the tail clamps
to P-1, the forward returns (count, 3) linear colour and the backward takes
its (count, 3) cotangent.

Each kernel is built with nvcc for sm_90a at first use into
raytpu_torch/build/, keyed by a hash of its sources and flags, and loaded
with ctypes.  A scene on the CPU goes to the plain version; a scene on a
CUDA device goes to the kernel or raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import subprocess
import time
from pathlib import Path

import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.scene import (Lights, Medium, Scene, Spheres, scene_from_leaves,
                                scene_leaves)
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

MAX_DEPTH = 8         # kMaxDepth, the kernels' per-thread stack bound
MAX_SPHERES = 4096    # with MAX_LIGHTS, keeps the forward's staged tables
MAX_LIGHTS = 1024     # within the 227 KB of shared memory a block may use
SMEM_BYTES = 232_448  # shared memory one block may use on sm_90
SCENE_ROWS, LIGHT_ROWS, BG_ROWS = 12, 6, 5

_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def _sources(path: Path) -> list[Path]:
    """`path` and every local header it includes, directly or not."""
    found = [path]
    for p in found:  # grows while it is walked
        for name in _INCLUDE.findall(p.read_text()):
            q = p.parent / name
            if q not in found:
                found.append(q)
    return found


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
        h = hashlib.sha256()
        for path in _sources(self.source):
            h.update(path.read_bytes())
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

TRACE_BWD = CudaKernel(
    "trace_bwd", "trace_bwd.cu", "raytpu_trace_bwd",
    # scene, n, lights, nl, bg, g, gout, offset, count, stride,
    # total_pixels, width, alias, max_depth, xstep, ystep, aspect, sub,
    # half_w, half_h, zoom, weight, device, stream
    [_p, _i, _p, _i, _p, _p, _p, _ll, _ll, _ll, _ll, _i, _i, _i,
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


def _pixel_ids(cfg: RenderConfig, offset: int, count: int, stride: int,
               device):
    gid = offset + torch.arange(count, dtype=torch.int64, device=device) * stride
    return torch.clamp(gid, max=cfg.num_pixels - 1)


def render_pixels_torch(scene, cfg: RenderConfig, offset: int = 0,
                        count: int | None = None, stride: int = 1):
    """The plain version: the eager tracer on the pixel set
    {offset + j*stride : j < count} clamped to P-1 -> (count, 3)."""
    offset, count, stride = _pixel_set(cfg, offset, count, stride)
    return render_pixels(scene, cfg,
                         _pixel_ids(cfg, offset, count, stride, scene.device))


def _check_depth(cfg: RenderConfig):
    if cfg.max_depth > MAX_DEPTH:
        raise ValueError(f"the kernels' stack bounds max_depth at {MAX_DEPTH}, "
                         f"got {cfg.max_depth}")


def _check_scene(scene, device):
    """Raise on any scene the kernels do not take."""
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


def _cuda_device(scene, name: str):
    device = scene.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} takes a CPU or CUDA scene, got {device}")
    return device


def render_pixels_cuda(scene, cfg: RenderConfig, offset: int = 0,
                       count: int | None = None, stride: int = 1):
    """Render the pixels {offset + j*stride : j < count} -> (count, 3).

    On a CUDA scene this launches the kernel (or raises); on a CPU scene it
    runs the plain version."""
    device = _cuda_device(scene, "render_pixels_cuda")
    if device.type == "cpu":
        return render_pixels_torch(scene, cfg, offset, count, stride)
    offset, count, stride = _pixel_set(cfg, offset, count, stride)
    _check_depth(cfg)
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


def _bwd_shared_bytes(n_spheres: int, n_lights: int) -> int:
    """Shared memory of one backward block: the scene tables and the
    block's gradient table, both 12N + 6L + 5 floats."""
    return 2 * 4 * (SCENE_ROWS * n_spheres + LIGHT_ROWS * n_lights + BG_ROWS)


def grads_from_table(tbl, n_spheres: int, n_lights: int) -> Scene:
    """A flat [scene (12, N) | lights (6, L) | background (5)] gradient
    table -> a Scene of gradients (the inverse of scene_tables)."""
    ns, nl = SCENE_ROWS * n_spheres, LIGHT_ROWS * n_lights
    s = tbl[:ns].reshape(SCENE_ROWS, n_spheres)
    lt = tbl[ns:ns + nl].reshape(LIGHT_ROWS, n_lights)
    b = tbl[ns + nl:]
    return Scene(
        spheres=Spheres(pos=s[0:3].T.contiguous(), radius=s[3].contiguous(),
                        matte=s[4:7].T.contiguous(), gloss=s[7:10].T.contiguous(),
                        opacity=s[10].contiguous(), ior=s[11].contiguous()),
        lights=Lights(pos=lt[0:3].T.contiguous(), col=lt[3:6].T.contiguous()),
        bg=Medium(matte=b[0:3].contiguous(), ior=b[3].contiguous(),
                  opacity=b[4].contiguous()))


def _check_cotangent(g, count: int, device):
    if tuple(g.shape) != (count, 3):
        raise ValueError(f"the cotangent has shape {tuple(g.shape)}, expected "
                         f"({count}, 3)")
    if g.dtype != torch.float32:
        raise TypeError(f"the cotangent is {g.dtype}, the kernel takes float32")
    if g.device != device:
        raise ValueError(f"the cotangent is on {g.device}, expected {device}")


def grad_pixels_torch(scene, cfg: RenderConfig, g, offset: int = 0,
                      count: int | None = None, stride: int = 1) -> Scene:
    """The backward's plain version: torch.autograd.grad of
    sum(render_pixels_torch(scene, cfg, offset, count, stride) * g), one
    chunk of cfg.chunk_pixels pixels at a time with the scene gradients
    summed over the chunks (one graph over a frame of config 3's 2.76 M
    camera rays would not fit the card).  Returns a Scene of gradients."""
    offset, count, stride = _pixel_set(cfg, offset, count, stride)
    _check_cotangent(g, count, scene.device)
    leaves = [t.detach().requires_grad_(True) for t in scene_leaves(scene)]
    ad_scene = scene_from_leaves(leaves)
    gid = _pixel_ids(cfg, offset, count, stride, scene.device)
    total = [torch.zeros_like(t) for t in leaves]
    with torch.enable_grad():
        for ids, g_chunk in zip(torch.split(gid, cfg.chunk_pixels),
                                torch.split(g, cfg.chunk_pixels)):
            out = render_pixels(ad_scene, cfg, ids)
            grads = torch.autograd.grad(torch.sum(out * g_chunk), leaves,
                                        allow_unused=True)
            for acc, d in zip(total, grads):
                if d is not None:
                    acc += d
    return scene_from_leaves(total)


def grad_pixels_cuda(scene, cfg: RenderConfig, g, offset: int = 0,
                     count: int | None = None, stride: int = 1) -> Scene:
    """The scene gradient of sum(render_pixels(pixels) * g) for the pixels
    {offset + j*stride : j < count}, clamped to P-1, with g (count, 3).

    On a CUDA scene this launches the backward kernel (or raises); on a CPU
    scene it runs the plain version.  Every j < count is a rendered pixel and
    takes its own g (the TPU kernel's zero-cotangent pad lanes do not exist
    here).  The kernel sums with atomics, so the last bits vary between
    runs."""
    device = _cuda_device(scene, "grad_pixels_cuda")
    if device.type == "cpu":
        return grad_pixels_torch(scene, cfg, g, offset, count, stride)
    offset, count, stride = _pixel_set(cfg, offset, count, stride)
    _check_depth(cfg)
    _check_scene(scene, device)
    _check_cotangent(g, count, device)
    n, nl = scene.spheres.count, scene.lights.count
    if _bwd_shared_bytes(n, nl) > SMEM_BYTES:
        raise ValueError(
            f"the backward kernel stages the scene and its gradient in shared "
            f"memory: 8 * (12N + 6L + 5) = {_bwd_shared_bytes(n, nl)} bytes for "
            f"N={n}, L={nl} exceeds {SMEM_BYTES}")
    gout = torch.zeros(SCENE_ROWS * n + LIGHT_ROWS * nl + BG_ROWS,
                       dtype=torch.float32, device=device)
    if count > 0:
        g_t = g.T.contiguous()  # (3, count), as the forward writes
        spheres_tbl, lights_tbl, bg_tbl = scene_tables(scene)
        cam = camera_constants(cfg)
        fn = TRACE_BWD.function()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(spheres_tbl.data_ptr(), n, lights_tbl.data_ptr(), nl,
                 bg_tbl.data_ptr(), g_t.data_ptr(), gout.data_ptr(),
                 offset, count, stride, cfg.num_pixels, cfg.width,
                 cfg.alias_factor, cfg.max_depth, *cam, device.index or 0,
                 stream)
        if err != 0:
            raise RuntimeError(f"trace_bwd launch failed: CUDA error {err}")
        TRACE_BWD.launches += 1
    return grads_from_table(gout, n, nl)


class RenderPixelsFn(torch.autograd.Function):
    """The differentiable render of a pixel set: forward render_pixels_cuda
    (the forward kernel on a CUDA scene), backward grad_pixels_cuda (the
    backward kernel) — the counterpart of raytpu's render_pixels_pallas_ad.
    The tensor inputs are the 11 scene leaves in scene_leaves order, so
    autograd routes each leaf its own gradient."""

    @staticmethod
    def forward(ctx, cfg, offset, count, stride, *leaves):
        ctx.cfg = cfg
        ctx.pixels = (offset, count, stride)
        ctx.save_for_backward(*leaves)
        return render_pixels_cuda(scene_from_leaves(leaves), cfg, offset, count,
                                  stride)

    @staticmethod
    def backward(ctx, g):
        scene = scene_from_leaves(ctx.saved_tensors)
        grads = grad_pixels_cuda(scene, ctx.cfg, g, *ctx.pixels)
        return (None, None, None, None, *scene_leaves(grads))


def render_pixels_cuda_ad(scene, cfg: RenderConfig, offset: int = 0,
                          count: int | None = None, stride: int = 1):
    """render_pixels_cuda that autograd differentiates with the backward
    kernel: (count, 3)."""
    return RenderPixelsFn.apply(cfg, offset, count, stride, *scene_leaves(scene))
