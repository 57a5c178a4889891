"""The wavefront tracer: one kernel per bounce level and a live-ray
compaction between levels (the counterpart of raytpu.kernels.wavefront).

The dense kernel walks each sample's whole bounce tree in one thread, so a
warp waits for its deepest tree.  The wavefront runs the frame as chunks of
camera rays and each chunk level by level:

  * K3, `wf_level` (csrc/wf_level.cu; it replaces wavefront.py:
    _make_wf_kernel): one node per ray over flat SoA state of N_STATE = 10
    fields (origin xyz, direction xyz, intensity rgb, and the medium as a
    sphere index held in a float, -1 for the background; the medium's
    values are regathered from the scene at every level, which is also the
    path medium cotangents take in the backward).  It writes 3 emission
    channels per ray and, on a spawning level, ray i's refraction child at
    2i and its reflection child at 2i+1, ten exact zeros where a child is
    not spawned;
  * K5, `compact` (csrc/wf_compact.cu; it replaces wavefront.py:
    _make_cursor_copy_kernel and the sorts around it): a stable prefix-sum
    stream compaction of the live children (intensity not all exactly
    zero) into a static capacity, with their pixel slot ids; the slots
    past the kept prefix hold zero state.  Live children past capacity are
    dropped and counted exactly.

Compaction is exact: a dead child carries zero intensity, and a ray of zero
intensity emits exact zeros and spawns nothing (wavefront.py:14-22).

The chunking is raytpu's, so that the same arguments give the same
capacities and the same drop counts: pixel-major strided chunks (chunk c
owns the window pixels {c + k * n_chunks : k < ws}, all spp samples of a
pixel adjacent), chunk = align_up(min(chunk_rays, total), lcm(8192, spp))
and cap = align_up(int(factor * chunk), 8192).  Level 0 accumulates by
the (ws, spp) reshape-sum; later levels `index_add_` their emissions into
the chunk's ws slots by the compacted slot ids, and each chunk writes its
slots into its strided pixels once.  That is all the accumulation there
is: raytpu's _segsum_scatter, _scatter_window, _unstripe,
_scatter_emissions and _dup_tilewise exist because a TPU pays ~3 ns per
scattered element and pads a narrow minor axis to 128 lanes; a GPU's
index_add_ scatters with atomics in L2 and a strided slice is a view.
`compact_mode`, `streams` and `interpret` have no counterpart (one
compaction; streams measured neutral on the TPU; no Pallas interpreter).

A scene on the CPU runs each kernel's plain version (`wf_level_torch`,
`compact_torch`); a scene on a CUDA device launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels.trace_cuda import (CudaKernel, _check_depth,
                                             _check_scene, _cuda_device,
                                             scene_tables)
from raytpu_torch.ops.geometry import normalize
from raytpu_torch.trace import _gather_medium, _trace_level, camera_constants

N_STATE = 10
# raytpu's chunk and capacity alignment (its 64 x 128-ray kernel block):
# kept so that the port and raytpu's global compaction size every level
# alike and count the same drops on the same arguments.
WF_BLOCK = 8192
# Rays per plain-version batch: bounds the eager tracer's (rays, lights,
# spheres) intermediates at config 5's 256 spheres.
PLAIN_RAYS = 1 << 15

_p, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

WF_LEVEL = CudaKernel(
    "wf_level", "wf_level.cu", "raytpu_wf_level",
    # scene, n, lights, nl, bg, state, rays, spawn, em, children, device,
    # stream
    [_p, _i, _p, _i, _p, _p, _ll, _i, _p, _p, _i, _p])

WF_COMPACT = CudaKernel(
    "wf_compact", "wf_compact.cu", "raytpu_wf_count",
    # children, kids, counts, device, stream
    [_p, _ll, _p, _i, _p],
    # children, kids, pid, starts, total, cap, n_slots, out, out_pid,
    # device, stream
    entries={"raytpu_wf_scatter": [_p, _ll, _p, _p, _p, _ll, _i, _p, _p,
                                   _i, _p]})

_COUNT_BLOCK = 1024  # children per block of wf_count_kernel


def _align_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _check_state(state, fields: int, device, name: str):
    if state.dim() != 2 or state.shape[0] != fields:
        raise ValueError(f"{name} has shape {tuple(state.shape)}, expected "
                         f"({fields}, rays)")
    if state.dtype != torch.float32:
        raise TypeError(f"{name} is {state.dtype}, the kernel takes float32")
    if state.device != device:
        raise ValueError(f"{name} is on {state.device}, expected {device}")
    if not state.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


# --------------------------------------------------------------------------
# K3: one bounce level.


def wf_level_torch(scene, state, spawn: bool):
    """K3's plain version: (emissions (3, R), children (10, 2R) or None)
    for the (10, R) state, through the eager tracer's _trace_level with
    the medium regathered from its index.  Children that are not spawned
    (zero intensity) are written as ten zeros, as the kernel writes them."""
    ems, kids = [], []
    for part in torch.split(state, PLAIN_RAYS, dim=1):
        rays = part.shape[1]
        mix = part[9]
        matte, ior, opacity = _gather_medium(scene.spheres, scene.bg,
                                             mix.to(torch.int64))
        em, children = _trace_level(scene, part[0:3].T, part[3:6].T,
                                    part[6:9].T, matte, ior, opacity, spawn,
                                    medium_idx=mix)
        ems.append(em.T)
        if spawn:
            origin, direction, intensity, index = children
            # [refraction block | reflection block] -> ray i's at 2i, 2i+1.
            fields = torch.cat([origin.T, direction.T, intensity.T, index[None]])
            fields = fields.reshape(N_STATE, 2, rays).transpose(1, 2).reshape(
                N_STATE, 2 * rays)
            alive = (fields[6:9] != 0).any(dim=0)
            kids.append(torch.where(alive, fields, torch.zeros_like(fields)))
    em = torch.cat(ems, dim=1)
    return em, (torch.cat(kids, dim=1) if spawn else None)


def wf_level(scene, state, spawn: bool, tables=None):
    """One bounce level over the (10, R) state: (emissions (3, R),
    children (10, 2R) or None).  On a CUDA scene this launches K3 (or
    raises); on a CPU scene it runs the plain version.  `tables` are the
    scene's scene_tables, if the caller has them already."""
    device = _cuda_device(scene, "wf_level")
    if device.type == "cpu":
        _check_state(state, N_STATE, device, "the ray state")
        return wf_level_torch(scene, state, spawn)
    _check_scene(scene, device)
    _check_state(state, N_STATE, device, "the ray state")
    rays = state.shape[1]
    em = torch.empty((3, rays), dtype=torch.float32, device=device)
    children = (torch.empty((N_STATE, 2 * rays), dtype=torch.float32,
                            device=device) if spawn else None)
    if rays == 0:
        return em, children
    spheres_tbl, lights_tbl, bg_tbl = tables or scene_tables(scene)
    fn = WF_LEVEL.function()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(spheres_tbl.data_ptr(), scene.spheres.count, lights_tbl.data_ptr(),
             scene.lights.count, bg_tbl.data_ptr(), state.data_ptr(), rays,
             int(spawn), em.data_ptr(),
             children.data_ptr() if spawn else None, device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"wf_level launch failed: CUDA error {err}")
    WF_LEVEL.launches += 1
    return em, children


# --------------------------------------------------------------------------
# K5: live-ray compaction.


def _check_compact(children, pid, cap: int, n_slots: int, device):
    _check_state(children, N_STATE, device, "the children")
    if pid.dim() != 1 or 2 * pid.shape[0] != children.shape[1]:
        raise ValueError(f"pid has shape {tuple(pid.shape)}; the children "
                         f"need one pid per parent ({children.shape[1] // 2})")
    if pid.dtype != torch.int32 or pid.device != device:
        raise TypeError(f"pid must be int32 on {device}, got {pid.dtype} on "
                        f"{pid.device}")
    if cap < 0 or n_slots < 1:
        raise ValueError(f"need cap >= 0 and n_slots >= 1, got {cap}, {n_slots}")


def compact_torch(children, pid, cap: int, n_slots: int):
    """K5's plain version.  children (10, 2R) with ray i's children at 2i
    and 2i+1, pid (R,) int32 the parents' slot ids.  Returns (state (10,
    cap), pid (cap,) int32, dropped, n_kept): the live children in order
    in the first n_kept slots with their parents' pids, zero state and pid
    (slot mod n_slots) after them; dropped = max(n_alive - cap, 0) and
    n_kept = min(n_alive, cap) as 0-d int64 tensors."""
    _check_compact(children, pid, cap, n_slots, children.device)
    device = children.device
    alive = (children[6:9] != 0).any(dim=0)
    rank = torch.cumsum(alive, dim=0) - 1
    total = alive.sum()
    keep = alive & (rank < cap)
    dest = rank[keep]
    slot = torch.arange(cap, dtype=torch.int64, device=device)
    state = torch.zeros((N_STATE, cap), dtype=torch.float32, device=device)
    out_pid = (slot % n_slots).to(torch.int32)
    state[:, dest] = children[:, keep]
    out_pid[dest] = pid.repeat_interleave(2)[keep]
    return (state, out_pid, torch.clamp(total - cap, min=0),
            torch.clamp(total, max=cap))


def compact(children, pid, cap: int, n_slots: int):
    """compact_torch's function; on CUDA tensors it launches K5 (a count
    kernel, a cumulative sum of the block counts, a scatter kernel) or
    raises."""
    device = children.device
    if device.type == "cpu":
        return compact_torch(children, pid, cap, n_slots)
    if device.type != "cuda":
        raise ValueError(f"compact takes CPU or CUDA tensors, got {device}")
    _check_compact(children, pid, cap, n_slots, device)
    kids = children.shape[1]
    blocks = -(-kids // _COUNT_BLOCK)
    counts = torch.empty(blocks, dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    dev = device.index or 0
    if kids > 0:
        err = WF_COMPACT.function("raytpu_wf_count")(
            children.data_ptr(), kids, counts.data_ptr(), dev, stream)
        if err != 0:
            raise RuntimeError(f"wf_count launch failed: CUDA error {err}")
        WF_COMPACT.launches += 1
        incl = torch.cumsum(counts, dim=0, dtype=torch.int64)
        starts = incl - counts
        total = incl[-1]
    else:
        starts = torch.zeros(1, dtype=torch.int64, device=device)
        total = torch.zeros((), dtype=torch.int64, device=device)
    state = torch.empty((N_STATE, cap), dtype=torch.float32, device=device)
    out_pid = torch.empty(cap, dtype=torch.int32, device=device)
    if max(kids, cap) > 0:
        err = WF_COMPACT.function("raytpu_wf_scatter")(
            children.data_ptr(), kids, pid.data_ptr(), starts.data_ptr(),
            total.data_ptr(), cap, n_slots, state.data_ptr(),
            out_pid.data_ptr(), dev, stream)
        if err != 0:
            raise RuntimeError(f"wf_scatter launch failed: CUDA error {err}")
        WF_COMPACT.launches += 1
    return (state, out_pid, torch.clamp(total - cap, min=0),
            torch.clamp(total, max=cap))


# --------------------------------------------------------------------------
# The orchestration.


def camera_state(cfg: RenderConfig, gp, si, sj, live):
    """The (10, R) state of camera rays: frame pixel `gp`, supersample
    (si, sj), unit intensity where `live` (else zero), the background
    medium.  Rounds as trace.camera_rays and the kernels' camera_dir."""
    c = camera_constants(cfg)
    ix = (gp % cfg.width).to(torch.float32)
    iy = (gp // cfg.width).to(torch.float32)
    px = (ix - c.half_w) * c.xstep
    py = (c.half_h - iy) * c.ystep
    x = (px + sj.to(torch.float32) * c.sub) * c.aspect
    y = py + si.to(torch.float32) * c.sub
    d = normalize(torch.stack([x, y, torch.full_like(x, c.zoom)], dim=-1))
    zero = torch.zeros_like(x)
    one = live.to(torch.float32)
    return torch.stack([zero, zero, zero, d[:, 0], d[:, 1], d[:, 2],
                        one, one, one, zero - 1.0])


def wavefront_sizes(cfg: RenderConfig, chunk_rays: int, capacity_factor,
                    count: int | None = None):
    """(chunk, ws, cap, n_chunks) as raytpu's _render_wavefront_impl sizes
    them for `count` window pixels (default: the frame)."""
    npix = cfg.num_pixels if count is None else int(count)
    spp = cfg.samples_per_pixel
    total = npix * spp
    chunk = _align_up(min(int(chunk_rays), total),
                      WF_BLOCK * spp // math.gcd(WF_BLOCK, spp))
    cap = _align_up(int(capacity_factor * chunk), WF_BLOCK)
    return chunk, chunk // spp, cap, -(-total // chunk)


def chunk_camera_state(cfg: RenderConfig, chunk: int, n_chunks: int, c: int,
                       npix: int, offset: int = 0, shard_stride: int = 1,
                       device="cpu"):
    """Chunk c's camera rays, pixel-major and strided: ray j is sample
    j % spp of slot k = j // spp, the window pixel c + k * n_chunks (frame
    pixel offset + that * shard_stride, clamped to P-1).  Returns the
    (10, chunk) state, zero intensity past the window, and the slot ids
    (chunk,) int32."""
    spp = cfg.samples_per_pixel
    ray = torch.arange(chunk, dtype=torch.int64, device=device)
    k, sample = ray // spp, ray % spp
    gpid = c + k * n_chunks
    gp = torch.clamp(offset + torch.clamp(gpid, max=npix - 1) * shard_stride,
                     max=cfg.num_pixels - 1)
    state = camera_state(cfg, gp, sample // cfg.alias_factor,
                         sample % cfg.alias_factor, gpid < npix)
    return state, k.to(torch.int32)


def render_pixels_wavefront(scene, cfg: RenderConfig, chunk_rays: int = 1 << 18,
                            capacity_factor=2, eager_sort: bool = True,
                            return_info: bool = False, offset: int = 0,
                            count: int | None = None, shard_stride: int = 1):
    """Wavefront render of the `count` frame pixels
    {offset + j*shard_stride : j < count}, clamped to P-1 -> (count, 3)
    linear colour (the full frame by default).

    `chunk_rays` camera rays per chunk bound the live memory;
    `capacity_factor` x chunk is every level's live-ray capacity.
    `eager_sort` compacts at every spawning level; without it a level
    whose children fit the capacity passes them on uncompacted (dead ones
    included).  With `return_info` it also returns {'dropped': 0-d int64
    tensor on the scene's device}, the live rays lost to capacity, summed
    over the frame on the device."""
    device = _cuda_device(scene, "render_pixels_wavefront")
    tables = None
    if device.type == "cuda":
        # Every kernel of the port takes max_depth <= kMaxDepth; the
        # wavefront keeps that bound so that every backend takes the same
        # configurations.
        _check_depth(cfg)
        _check_scene(scene, device)
        tables = scene_tables(scene)
    npix = cfg.num_pixels if count is None else int(count)
    if offset < 0 or shard_stride < 1 or npix < 1:
        raise ValueError(f"need offset >= 0, shard_stride >= 1 and count >= 1, "
                         f"got offset={offset} shard_stride={shard_stride} "
                         f"count={npix}")
    spp = cfg.samples_per_pixel
    chunk, ws, cap, n_chunks = wavefront_sizes(cfg, chunk_rays, capacity_factor,
                                               npix)
    acc = torch.zeros((3, npix), dtype=torch.float32, device=device)
    dropped = torch.zeros((), dtype=torch.int64, device=device)
    for c in range(n_chunks):
        state, pid = chunk_camera_state(cfg, chunk, n_chunks, c, npix, offset,
                                        shard_stride, device)
        for level in range(cfg.max_depth + 1):
            spawn = level < cfg.max_depth
            em, children = wf_level(scene, state, spawn, tables)
            if level == 0:
                accw = em.reshape(3, ws, spp).sum(dim=2)
            else:
                accw.index_add_(1, pid, em)
            if not spawn:
                break
            rays = state.shape[1]
            if 2 * rays <= cap and not eager_sort:
                state, pid = children, pid.repeat_interleave(2)
            else:
                state, pid, lost, _ = compact(children, pid, min(2 * rays, cap), ws)
                dropped += lost
        # Slot k of chunk c is window pixel c + k * n_chunks.
        mine = acc[:, c::n_chunks]
        mine.copy_(accw[:, :mine.shape[1]])
    img = (acc * camera_constants(cfg).weight).T
    return (img, dict(dropped=dropped)) if return_info else img


def render_image_wavefront(scene, cfg: RenderConfig, **kw):
    """(H, W, 3) frame through render_pixels_wavefront; with
    return_info=True, (frame, info)."""
    out = render_pixels_wavefront(scene, cfg, **kw)
    if isinstance(out, tuple):
        img, info = out
        return img.reshape(cfg.height, cfg.width, 3), info
    return out.reshape(cfg.height, cfg.width, 3)
