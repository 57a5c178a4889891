"""The fused dense forward and backward as hand-written CUDA kernels
(csrc/trace_fwd.cu, csrc/trace_bwd.cu), their build and binding, their
plain PyTorch versions, and the autograd Function that pairs them.

They replace raytpu/kernels/trace_pallas.py:_make_kernel and
_make_bwd_kernel.  The interface is the TPU kernels': `offset`, `count` and
`stride` select the pixels {offset + j*stride : j < count}, the tail clamps
to P-1, the forward returns (count, 3) linear colour and the backward takes
its (count, 3) cotangent.

raytpu's training step also runs in the TPU kernels' own tiled layout, (3,
tiles*TILE_ROWS, LANES) with the tail lanes padded (pack_pixel_tiles,
render_tiles_pallas_ad).  The port keeps that API (pack_pixel_tiles,
unpack_pixel_tiles, tile_mask, render_tiles_cuda_ad) on the same kernels:
the layout answers the TPU's 128 lanes, so K1 and K2 keep their (count, 3)
interface and the tiles are a pack and an unpack around them.

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
from raytpu_torch.device import resolve_device
from raytpu_torch.scene import (LEAF_NAMES, Lights, Medium, Scene, Spheres,
                                scene_from_leaves, scene_leaves)
from raytpu_torch.trace import camera_constants, render_pixels
from raytpu_torch.utils import profiling
from raytpu_torch.utils.profiling import scoped

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

# raytpu's tiled pixel layout (trace_pallas.py:41-43): a tile is TILE_ROWS
# rows of LANES pixels.
LANES = 128
TILE_ROWS = 8
TILE_PIXELS = TILE_ROWS * LANES

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
    """One CUDA source file built into a shared library with plain C entry
    points, and the count of its launches.

    `symbol` and `argtypes` name the main entry point; `entries` maps the
    names of any others in the same library to their argtypes.
    `launches` is a plain integer that the wrapper adds one to where it
    launches a kernel, and nowhere else; a caller may reset it.
    profiling.counters() reports it, and the seconds of every library's
    first load (nvcc's included where it builds)."""

    def __init__(self, name: str, source: str, symbol: str, argtypes,
                 entries: dict | None = None):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.entries = {symbol: argtypes, **(entries or {})}
        self.launches = 0
        self.build_log = ""
        self._lib = None
        profiling.register_kernel(self)

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

    def function(self, symbol: str | None = None):
        """The bound C entry point `symbol` (default: the main one),
        building and loading the library first if needed."""
        if self._lib is None:
            t0 = time.perf_counter()
            built = self.build() > 0
            lib = ctypes.CDLL(str(self.library_path()))
            for name, argtypes in self.entries.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self._lib = lib
            profiling.kernel_loaded(time.perf_counter() - t0, built)
        return getattr(self._lib, symbol or self.symbol)


_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# scene, n, lights, nl, bg, out, offset, count, stride, total_pixels, width,
# alias, max_depth, xstep, ystep, aspect, sub, half_w, half_h, zoom, weight,
# device, stream
_FWD_ARGS = [_p, _i, _p, _i, _p, _p, _ll, _ll, _ll, _ll, _i, _i, _i,
             _f, _f, _f, _f, _f, _f, _f, _f, _i, _p]
TRACE_FWD = CudaKernel(
    "trace_fwd", "trace_fwd.cu", "raytpu_trace_fwd", _FWD_ARGS,
    # the previous design, the reference instance: the same arguments
    entries={"raytpu_trace_fwd_ref": _FWD_ARGS})

# scene, n, lights, nl, bg, g, gout, offset, count, stride, total_pixels,
# width, alias, max_depth, xstep, ystep, aspect, sub, half_w, half_h, zoom,
# weight, device, stream
_BWD_ARGS = [_p, _i, _p, _i, _p, _p, _p, _ll, _ll, _ll, _ll, _i, _i, _i,
             _f, _f, _f, _f, _f, _f, _f, _f, _i, _p]
TRACE_BWD = CudaKernel(
    "trace_bwd", "trace_bwd.cu", "raytpu_trace_bwd", _BWD_ARGS,
    # the previous design, the reference instance: the same arguments
    entries={"raytpu_trace_bwd_ref": _BWD_ARGS})


@scoped("scene.tables")
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
                        count: int | None = None, stride: int = 1, view=None):
    """The plain version: the eager tracer on the pixel set
    {offset + j*stride : j < count} clamped to P-1 -> (count, 3), from
    the posed camera `view` where given (trace.render_pixels)."""
    offset, count, stride = _pixel_set(cfg, offset, count, stride)
    return render_pixels(scene, cfg,
                         _pixel_ids(cfg, offset, count, stride, scene.device),
                         view=view)


def _check_depth(cfg: RenderConfig):
    if cfg.max_depth > MAX_DEPTH:
        raise ValueError(f"the dense kernels' stack bounds max_depth at "
                         f"{MAX_DEPTH}, got {cfg.max_depth}")


def dense_takes(scene, cfg: RenderConfig) -> bool:
    """Whether the dense kernels (K1, K2) take `scene` at `cfg`: a depth
    their per-thread stack holds and tables their blocks can stage.  The
    wavefront takes any depth and size."""
    return (cfg.max_depth <= MAX_DEPTH and scene.spheres.count <= MAX_SPHERES
            and scene.lights.count <= MAX_LIGHTS)


def _bwd_shared_bytes(n_spheres: int, n_lights: int) -> int:
    """Shared memory of one backward block: the scene tables and the
    block's gradient table, both 12N + 6L + 5 floats."""
    return 2 * 4 * (SCENE_ROWS * n_spheres + LIGHT_ROWS * n_lights + BG_ROWS)


def bwd_takes(n_spheres: int, n_lights: int) -> bool:
    """Whether K2's block can stage N spheres' and L lights' tables and
    their gradient table in shared memory; dense_takes holds the rest of
    what K2 takes."""
    return _bwd_shared_bytes(n_spheres, n_lights) <= SMEM_BYTES


# Every scene tensor the kernels read: (group, field, its shape after the
# group's count, or None for the background's fixed shape).
_SCENE_FIELDS = (("spheres", "pos", (3,)), ("spheres", "radius", ()),
                 ("spheres", "matte", (3,)), ("spheres", "gloss", (3,)),
                 ("spheres", "opacity", ()), ("spheres", "ior", ()),
                 ("lights", "pos", (3,)), ("lights", "col", (3,)),
                 ("bg", "matte", None), ("bg", "ior", None),
                 ("bg", "opacity", None))
_BG_SHAPES = {"matte": (3,), "ior": (), "opacity": ()}


def _check_scene(scene, device, bounded: bool = True):
    """Raise on any scene the kernels do not take.  `bounded`: the bounds
    of the kernels that stage the scene in shared memory (K1, K2 and the
    reference instances); the wavefront's kernels (bounded=False) read a
    table too large to stage from global memory, and take any N >= 1."""
    n, nl = scene.spheres.count, scene.lights.count
    if n < 1 or bounded and n > MAX_SPHERES:
        raise ValueError(f"the kernel takes 1..{MAX_SPHERES if bounded else 'any'} "
                         f"spheres, got {n}")
    if nl < 0 or bounded and nl > MAX_LIGHTS:
        raise ValueError(f"the kernel takes 0..{MAX_LIGHTS} lights, got {nl}")
    counts = {"spheres": (n,), "lights": (nl,)}
    for group, name, tail in _SCENE_FIELDS:
        t = getattr(getattr(scene, group), name)
        shape = _BG_SHAPES[name] if tail is None else counts[group] + tail
        if t.device != device or t.dtype != torch.float32 or t.shape != shape:
            key = f"{group}.{name}"
            if t.device != device:
                raise ValueError(f"{key} is on {t.device}, expected {device}")
            if t.dtype != torch.float32:
                raise TypeError(f"{key} is {t.dtype}, the kernel takes float32")
            raise ValueError(f"{key} has shape {tuple(t.shape)}, expected {shape}")


def _cuda_device(scene, name: str):
    device = scene.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} takes a CPU or CUDA scene, got {device}")
    return device


@scoped("k1.launch")
def _fwd_launch(entry: str, scene, cfg: RenderConfig, offset: int, count,
                stride: int, tables=None):
    """Launch `entry` of K1's library on a CUDA scene -> (count, 3), or
    raise on what the kernel does not take.  `tables`: scene_tables(scene),
    where the caller has them."""
    device = _cuda_device(scene, entry)
    offset, count, stride = _pixel_set(cfg, offset, count, stride)
    _check_depth(cfg)
    _check_scene(scene, device)
    out = torch.empty((3, count), dtype=torch.float32, device=device)
    if count == 0:
        return out.T
    spheres_tbl, lights_tbl, bg_tbl = tables or scene_tables(scene)
    err = TRACE_FWD.function(entry)(
        spheres_tbl.data_ptr(), scene.spheres.count, lights_tbl.data_ptr(),
        scene.lights.count, bg_tbl.data_ptr(), out.data_ptr(), offset, count,
        stride, cfg.num_pixels, cfg.width, cfg.alias_factor, cfg.max_depth,
        *camera_constants(cfg), device.index or 0,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    if entry == TRACE_FWD.symbol:
        TRACE_FWD.launches += 1
    return out.T


def render_pixels_cuda(scene, cfg: RenderConfig, offset: int = 0,
                       count: int | None = None, stride: int = 1, tables=None):
    """Render the pixels {offset + j*stride : j < count} -> (count, 3).

    On a CUDA scene this launches the kernel (or raises); on a CPU scene it
    runs the plain version.  `tables`: scene_tables(scene), where the
    caller has built them."""
    if _cuda_device(scene, "render_pixels_cuda").type == "cpu":
        return render_pixels_torch(scene, cfg, offset, count, stride)
    return _fwd_launch(TRACE_FWD.symbol, scene, cfg, offset, count, stride,
                       tables)


def render_pixels_reference(scene, cfg: RenderConfig, offset: int = 0,
                            count: int | None = None, stride: int = 1):
    """render_pixels_cuda through K1's reference instance, the previous
    design (one thread per pixel walking its alias^2 trees in a row), on a
    CUDA scene: what the kernel is held to, bit for bit, and timed
    against.  Not counted in TRACE_FWD.launches, and never on the main
    path."""
    return _fwd_launch("raytpu_trace_fwd_ref", scene, cfg, offset, count,
                       stride)


def render_image_cuda(scene, cfg: RenderConfig):
    """(H, W, 3) frame through render_pixels_cuda."""
    return render_pixels_cuda(scene, cfg).reshape(cfg.height, cfg.width, 3)


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


@scoped("k2.launch")
def _grad_launch(entry: str, scene, cfg: RenderConfig, g, offset: int,
                 count, stride: int, tables=None) -> Scene:
    """Launch `entry` of K2's library on a CUDA scene; returns the gradient
    Scene, or raises on what the kernel does not take.  `tables`:
    scene_tables(scene), where the caller has them."""
    device = _cuda_device(scene, entry)
    offset, count, stride = _pixel_set(cfg, offset, count, stride)
    _check_depth(cfg)
    _check_scene(scene, device)
    _check_cotangent(g, count, device)
    n, nl = scene.spheres.count, scene.lights.count
    if not bwd_takes(n, nl):
        raise ValueError(
            f"the backward kernel stages the scene and its gradient in shared "
            f"memory: 8 * (12N + 6L + 5) = {_bwd_shared_bytes(n, nl)} bytes for "
            f"N={n}, L={nl} exceeds {SMEM_BYTES}")
    gout = torch.zeros(SCENE_ROWS * n + LIGHT_ROWS * nl + BG_ROWS,
                       dtype=torch.float32, device=device)
    if count > 0:
        g_t = g.T.contiguous()  # (3, count), as the forward writes
        spheres_tbl, lights_tbl, bg_tbl = tables or scene_tables(scene)
        cam = camera_constants(cfg)
        fn = TRACE_BWD.function(entry)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(spheres_tbl.data_ptr(), n, lights_tbl.data_ptr(), nl,
                 bg_tbl.data_ptr(), g_t.data_ptr(), gout.data_ptr(),
                 offset, count, stride, cfg.num_pixels, cfg.width,
                 cfg.alias_factor, cfg.max_depth, *cam, device.index or 0,
                 stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
        if entry == TRACE_BWD.symbol:
            TRACE_BWD.launches += 1
    return grads_from_table(gout, n, nl)


def grad_pixels_cuda(scene, cfg: RenderConfig, g, offset: int = 0,
                     count: int | None = None, stride: int = 1,
                     tables=None) -> Scene:
    """The scene gradient of sum(render_pixels(pixels) * g) for the pixels
    {offset + j*stride : j < count}, clamped to P-1, with g (count, 3).

    On a CUDA scene this launches the backward kernel (or raises); on a CPU
    scene it runs the plain version.  Every j < count is a rendered pixel and
    takes its own g (the TPU kernel's zero-cotangent pad lanes do not exist
    here).  The kernel sums with atomics, so the last bits vary between
    runs.  `tables`: scene_tables(scene), where the caller has built
    them."""
    if _cuda_device(scene, "grad_pixels_cuda").type == "cpu":
        return grad_pixels_torch(scene, cfg, g, offset, count, stride)
    return _grad_launch(TRACE_BWD.symbol, scene, cfg, g, offset, count, stride,
                        tables)


def grad_pixels_reference(scene, cfg: RenderConfig, g, offset: int = 0,
                          count: int | None = None, stride: int = 1) -> Scene:
    """grad_pixels_cuda through K2's reference instance, the previous design
    (one thread per pixel, the sphere loops run again in the adjoint), on a
    CUDA scene: what the kernel is held to and timed against.  Not counted
    in TRACE_BWD.launches, and never on the main path."""
    return _grad_launch("raytpu_trace_bwd_ref", scene, cfg, g, offset, count,
                        stride)


class RenderPixelsFn(torch.autograd.Function):
    """The differentiable render of a pixel set: forward render_pixels_cuda
    (the forward kernel on a CUDA scene), backward grad_pixels_cuda (the
    backward kernel) — the counterpart of raytpu's render_pixels_pallas_ad.
    The tensor inputs are the 11 scene leaves in scene_leaves order, so
    autograd routes each leaf its own gradient.  The scene tables are built
    once, in the forward, and saved for the backward's kernel (autograd's
    version check on the saved leaves still catches an in-place update
    between the two)."""

    @staticmethod
    def forward(ctx, cfg, offset, count, stride, *leaves):
        ctx.cfg = cfg
        ctx.pixels = (offset, count, stride)
        scene = scene_from_leaves(leaves)
        tables = scene_tables(scene) if scene.device.type == "cuda" else None
        ctx.save_for_backward(*leaves, *(tables or ()))
        return render_pixels_cuda(scene, cfg, offset, count, stride, tables)

    @staticmethod
    def backward(ctx, g):
        saved = ctx.saved_tensors
        scene = scene_from_leaves(saved[:len(LEAF_NAMES)])
        grads = grad_pixels_cuda(scene, ctx.cfg, g, *ctx.pixels,
                                 tables=saved[len(LEAF_NAMES):] or None)
        return (None, None, None, None, *scene_leaves(grads))


def render_pixels_cuda_ad(scene, cfg: RenderConfig, offset: int = 0,
                          count: int | None = None, stride: int = 1):
    """render_pixels_cuda that autograd differentiates with the backward
    kernel: (count, 3)."""
    return RenderPixelsFn.apply(cfg, offset, count, stride, *scene_leaves(scene))


def pack_pixel_tiles(flat, count: int | None = None):
    """(count, 3) pixel data -> raytpu's tiled layout (3, tiles*TILE_ROWS,
    LANES), the tail zero-padded, on flat's device (the counterpart of
    raytpu.kernels.trace_pallas.pack_pixel_tiles)."""
    if count is None:
        count = flat.shape[0]
    tiles = -(-count // TILE_PIXELS)
    pad = tiles * TILE_PIXELS - count
    # One copy: the channels of flat.T, each padded to whole tiles.
    padded = torch.nn.functional.pad(flat.T, (0, pad))
    return padded.reshape(3, tiles * TILE_ROWS, LANES)


def unpack_pixel_tiles(tbl, count: int):
    """Inverse of pack_pixel_tiles: (3, R, LANES) -> (count, 3)."""
    return tbl.reshape(3, -1).T[:count]


def tile_mask(count: int, device=None):
    """(rows, LANES) float32 mask of a `count`-pixel block's tiles: 1 where
    the lane holds a pixel, 0 on the tail pad (whose lanes repeat the last
    pixel and must not count in a loss).  `device` defaults to this
    process's card (device.local_device), which raises without one."""
    device = resolve_device(device)
    tiles = -(-count // TILE_PIXELS)
    lane = torch.arange(tiles * TILE_PIXELS, device=device)
    return (lane < count).to(torch.float32).reshape(tiles * TILE_ROWS, LANES)


def render_tiles_cuda_ad(scene, cfg: RenderConfig, offset: int = 0,
                         count: int | None = None):
    """render_pixels_cuda_ad of the pixels offset .. offset+count-1 in
    raytpu's tiled layout: (3, tiles*TILE_ROWS, LANES), and autograd takes
    its cotangent in that shape (the counterpart of
    raytpu.kernels.trace_pallas.render_tiles_pallas_ad).

    Lane j holds pixel min(offset + j, P-1), as in the TPU kernel: the
    tail lanes past `count` hold the pixels that follow, up to the frame's
    last, and then repeat it.  One forward kernel launch renders every
    distinct pixel of the tiles; the tail is detached, so its cotangent is
    dropped: a plain sum over the tiled output has the flat output's
    gradient, and the one backward kernel launch takes a zero cotangent on
    the tail's pixels.  On a CPU scene the plain versions run; a CUDA scene
    the dense kernels do not take (dense_takes, or the backward's shared
    memory) raises."""
    count = cfg.num_pixels if count is None else int(count)
    lanes = -(-count // TILE_PIXELS) * TILE_PIXELS
    distinct = min(lanes, cfg.num_pixels - offset)
    # (3, distinct) as the kernel writes it; one copy appends the repeats.
    channels = render_pixels_cuda_ad(scene, cfg, offset, distinct).T
    parts = [channels[:, :count], channels[:, count:].detach(),
             channels[:, -1:].detach().expand(3, lanes - distinct)]
    return torch.cat(parts, dim=1).reshape(3, -1, LANES)
