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
    not spawned.  Each ray culls the spheres it tests through the frame's
    BVH (kernels/bvh.py, built once per frame beside scene_tables); on the
    training path it also writes the node's selections `sel`;
  * K5, `compact` (csrc/wf_compact.cu; it replaces wavefront.py:
    _make_cursor_copy_kernel and the sorts around it): a stable prefix-sum
    stream compaction of the live children (intensity not all exactly
    zero) into a static capacity, with their pixel slot ids; the slots
    past the kept prefix hold zero state.  Live children past capacity are
    dropped and counted exactly.

Compaction is exact: a dead child carries zero intensity, and a ray of zero
intensity emits exact zeros and spawns nothing (wavefront.py:14-22).

Differentiable (the counterpart of raytpu's custom VJPs _wf_level_ad and
_compact_blocked_ad): when grad is enabled and a scene leaf requires grad,
each level runs as WfLevelFn and each compaction as CompactFn, and autograd
differentiates the glue (the level-0 reshape-sum, `index_add_`, the
strided copy into the frame, scene_tables' concatenation):

  * K4, `wf_level_bwd` (csrc/wf_level_bwd.cu; it replaces wavefront.py:
    _make_wf_bwd_kernel): one level's backward, the hand-written node
    adjoint of trace_adjoint.cuh over the same state, with the medium's
    cotangents routed through the index's gather into the scene table and
    the node's sphere queries answered from K3's saved `sel`;
  * K6, `uncompact` (csrc/wf_uncompact.cu; it replaces wavefront.py:
    _make_inverse_cursor_kernel and the inverse co-sorts around it): the
    compaction's transpose, the slot cotangents back to the child columns
    K5 kept them from (its saved `src`), exact zeros everywhere else.

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
`compact_torch`, `wf_level_bwd_torch`, `uncompact_torch`); a scene on a
CUDA device launches the kernels or raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels.bvh import Bvh, build_bvh
from raytpu_torch.kernels.trace_cuda import (BG_ROWS, LIGHT_ROWS, SCENE_ROWS,
                                             SMEM_BYTES, CudaKernel,
                                             _bwd_shared_bytes, _check_depth,
                                             _check_scene, _cuda_device,
                                             scene_tables)
from raytpu_torch.ops.geometry import normalize
from raytpu_torch.scene import scene_from_leaves, scene_leaves
from raytpu_torch.trace import _gather_medium, _trace_level, camera_constants

N_STATE = 10
N_DIFF = 9  # the state fields with a cotangent: not the medium index
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
    # scene, n, lights, nl, bg, boxes, order, n_leaves, state, rays, spawn,
    # em, children, sel, device, stream
    [_p, _i, _p, _i, _p, _p, _p, _i, _p, _ll, _i, _p, _p, _p, _i, _p],
    # the brute-force reference instance: scene, n, lights, nl, bg, state,
    # rays, spawn, em, children, sel, device, stream
    entries={"raytpu_wf_level_ref": [_p, _i, _p, _i, _p, _p, _ll, _i, _p, _p,
                                     _p, _i, _p]})

WF_COMPACT = CudaKernel(
    "wf_compact", "wf_compact.cu", "raytpu_wf_count",
    # children, kids, counts, device, stream
    [_p, _ll, _p, _i, _p],
    # children, kids, pid, starts, total, cap, n_slots, out, out_pid, src,
    # device, stream
    entries={"raytpu_wf_scatter": [_p, _ll, _p, _p, _p, _ll, _i, _p, _p, _p,
                                   _i, _p]})

# scene, n, lights, nl, bg, state, rays, spawn, em_ct, ch_ct, sel, d_state,
# gout, shared_grad, device, stream
_LEVEL_BWD_ARGS = [_p, _i, _p, _i, _p, _p, _ll, _i, _p, _p, _p, _p, _p, _i, _i, _p]
WF_LEVEL_BWD = CudaKernel(
    "wf_level_bwd", "wf_level_bwd.cu", "raytpu_wf_level_bwd", _LEVEL_BWD_ARGS,
    # the reference instance re-running the brute-force queries (sel unread)
    entries={"raytpu_wf_level_bwd_ref": _LEVEL_BWD_ARGS})

WF_UNCOMPACT = CudaKernel(
    "wf_uncompact", "wf_uncompact.cu", "raytpu_wf_uncompact",
    # d_state, cap, src, kids, d_children, device, stream
    [_p, _ll, _p, _ll, _p, _i, _p])

_COUNT_BLOCK = 1024  # children per block of wf_count_kernel


def _align_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _check_state(state, fields: int, device, name: str, cols: int | None = None):
    if (state.dim() != 2 or state.shape[0] != fields
            or cols is not None and state.shape[1] != cols):
        raise ValueError(f"{name} has shape {tuple(state.shape)}, expected "
                         f"({fields}, {'rays' if cols is None else cols})")
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


def sel_rows(n_lights: int) -> int:
    """Rows of the selections K3 saves for K4: the hit sphere, the container
    and ceil(L / 32) words of lit-light bits."""
    return 2 + -(-n_lights // 32)


def _level_outputs(scene, state, spawn: bool, return_sel: bool):
    rays, device = state.shape[1], state.device
    em = torch.empty((3, rays), dtype=torch.float32, device=device)
    children = (torch.empty((N_STATE, 2 * rays), dtype=torch.float32,
                            device=device) if spawn else None)
    sel = (torch.empty((sel_rows(scene.lights.count), rays), dtype=torch.int32,
                       device=device) if return_sel else None)
    return em, children, sel


def _level_result(em, children, sel, return_sel: bool):
    return (em, children, sel) if return_sel else (em, children)


def wf_level(scene, state, spawn: bool, tables=None, bvh: Bvh | None = None,
             return_sel: bool = False):
    """One bounce level over the (10, R) state: (emissions (3, R),
    children (10, 2R) or None), and with `return_sel` also the node's
    selections sel ((2 + ceil(L/32), R) int32: the hit sphere, the
    container where the node spawned, the lit-light bits; None on the CPU,
    whose plain version needs none).  On a CUDA scene this launches K3 (or
    raises); on a CPU scene it runs the plain version.  `tables` are the
    scene's scene_tables and `bvh` its build_bvh, if the caller has them
    already."""
    device = _cuda_device(scene, "wf_level")
    if device.type == "cpu":
        _check_state(state, N_STATE, device, "the ray state")
        return _level_result(*wf_level_torch(scene, state, spawn), None,
                             return_sel)
    _check_scene(scene, device)
    _check_state(state, N_STATE, device, "the ray state")
    em, children, sel = _level_outputs(scene, state, spawn, return_sel)
    rays = state.shape[1]
    if rays == 0:
        return _level_result(em, children, sel, return_sel)
    spheres_tbl, lights_tbl, bg_tbl = tables or scene_tables(scene)
    bvh = bvh or build_bvh(spheres_tbl, lights_tbl)
    fn = WF_LEVEL.function()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(spheres_tbl.data_ptr(), scene.spheres.count, lights_tbl.data_ptr(),
             scene.lights.count, bg_tbl.data_ptr(), bvh.boxes.data_ptr(),
             bvh.order.data_ptr(), bvh.n_leaves, state.data_ptr(), rays,
             int(spawn), em.data_ptr(), children.data_ptr() if spawn else None,
             sel.data_ptr() if return_sel else None, device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"wf_level launch failed: CUDA error {err}")
    WF_LEVEL.launches += 1
    return _level_result(em, children, sel, return_sel)


def wf_level_reference(scene, state, spawn: bool, tables=None,
                       return_sel: bool = False):
    """wf_level through K3's reference instance (the brute-force loops over
    every sphere) on a CUDA scene: what the BVH instance is held to bit for
    bit and timed against.  Not counted in WF_LEVEL.launches, and never on
    the main path."""
    device = state.device
    _check_scene(scene, device)
    _check_state(state, N_STATE, device, "the ray state")
    em, children, sel = _level_outputs(scene, state, spawn, return_sel)
    spheres_tbl, lights_tbl, bg_tbl = tables or scene_tables(scene)
    err = WF_LEVEL.function("raytpu_wf_level_ref")(
        spheres_tbl.data_ptr(), scene.spheres.count, lights_tbl.data_ptr(),
        scene.lights.count, bg_tbl.data_ptr(), state.data_ptr(), state.shape[1],
        int(spawn), em.data_ptr(), children.data_ptr() if spawn else None,
        sel.data_ptr() if return_sel else None, device.index or 0,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wf_level_ref launch failed: CUDA error {err}")
    return _level_result(em, children, sel, return_sel)


# --------------------------------------------------------------------------
# K4: one level's backward.


def wf_level_bwd_torch(scene, state, em_ct, ch_ct, spawn: bool):
    """K4's plain version: torch.autograd.grad of
    sum(em * em_ct) + sum(children * ch_ct) through wf_level_torch with
    respect to the scene leaves and the state, PLAIN_RAYS rays at a time,
    the scene gradients summed.  Returns (d_state (10, R), d_spheres (12,
    N), d_lights (6, L), d_bg (5,)), the tables laid out as scene_tables.
    d_state is zero in the medium-index row and on dead rays (intensity
    all exactly zero), as K4 writes it: autograd would give a dead ray that
    misses gw * M, which no cotangent can carry to the scene, since a dead
    ray comes from a slot or child that no live ray spawned."""
    leaves = [t.detach().requires_grad_(True) for t in scene_leaves(scene)]
    ad_scene = scene_from_leaves(leaves)
    total = [torch.zeros_like(t) for t in leaves]
    d_state = torch.zeros_like(state)
    rays = state.shape[1]
    with torch.enable_grad():
        for lo in range(0, rays, PLAIN_RAYS):
            hi = min(lo + PLAIN_RAYS, rays)
            part = state[:, lo:hi].detach().requires_grad_(True)
            em, kids = wf_level_torch(ad_scene, part, spawn)
            out = torch.sum(em * em_ct[:, lo:hi])
            if spawn:
                out = out + torch.sum(kids * ch_ct[:, 2 * lo:2 * hi])
            *grads, d_part = torch.autograd.grad(out, leaves + [part],
                                                 allow_unused=True)
            for acc, d in zip(total, grads):
                if d is not None:
                    acc += d
            if d_part is not None:
                d_state[:N_DIFF, lo:hi] = d_part[:N_DIFF]
    d_state[:, (state[6:9] == 0).all(dim=0)] = 0.0
    return (d_state, *scene_tables(scene_from_leaves(total)))


def _check_sel(sel, scene, rays: int, device):
    rows = sel_rows(scene.lights.count)
    if sel is None:
        raise ValueError("wf_level_bwd on a CUDA scene needs sel, the "
                         "selections wf_level(..., return_sel=True) saved for "
                         "this state")
    if tuple(sel.shape) != (rows, rays) or sel.dtype != torch.int32:
        raise ValueError(f"sel is {sel.dtype} {tuple(sel.shape)}, expected "
                         f"int32 ({rows}, {rays})")
    if sel.device != device or not sel.is_contiguous():
        raise ValueError(f"sel must be contiguous on {device}")


def _level_bwd_launch(entry, scene, state, em_ct, ch_ct, spawn, tables,
                      need_state, sel):
    """Launch `entry` of K4's library (the reference entry does not read
    sel).  Returns (d_state or None, the three tables)."""
    device = state.device
    rays = state.shape[1]
    n, nl = scene.spheres.count, scene.lights.count
    ns, nls = SCENE_ROWS * n, LIGHT_ROWS * nl
    gout = torch.zeros(ns + nls + BG_ROWS, dtype=torch.float32, device=device)
    d_state = torch.empty_like(state) if need_state else None
    if rays > 0:
        spheres_tbl, lights_tbl, bg_tbl = tables or scene_tables(scene)
        err = WF_LEVEL_BWD.function(entry)(
            spheres_tbl.data_ptr(), n, lights_tbl.data_ptr(), nl,
            bg_tbl.data_ptr(), state.data_ptr(), rays, int(spawn),
            em_ct.data_ptr(), ch_ct.data_ptr() if spawn else None,
            sel.data_ptr() if sel is not None else None,
            d_state.data_ptr() if need_state else None, gout.data_ptr(),
            int(_bwd_shared_bytes(n, nl) <= SMEM_BYTES), device.index or 0,
            torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    return (d_state, gout[:ns].view(SCENE_ROWS, n),
            gout[ns:ns + nls].view(LIGHT_ROWS, nl), gout[ns + nls:])


def wf_level_bwd(scene, state, em_ct, ch_ct, spawn: bool, tables=None,
                 need_state: bool = True, sel=None):
    """The backward of wf_level(scene, state, spawn) for the cotangents
    em_ct (3, R) of its emissions and ch_ct (10, 2R) of its children (None
    when not `spawn`): (d_state (10, R) or None without `need_state`,
    d_spheres (12, N), d_lights (6, L), d_bg (5,)).  On a CUDA scene this
    launches K4, which reads `sel`, the selections
    wf_level(..., return_sel=True) wrote for this state, and raises without
    them; on a CPU scene it runs the plain version, which needs no sel.
    The kernel sums with atomics, so the tables' last bits vary between
    runs."""
    device = _cuda_device(scene, "wf_level_bwd")
    _check_state(state, N_STATE, device, "the ray state")
    rays = state.shape[1]
    _check_state(em_ct, 3, device, "the emission cotangent", rays)
    if spawn:
        _check_state(ch_ct, N_STATE, device, "the children's cotangent", 2 * rays)
    if device.type == "cpu":
        d_state, *grads = wf_level_bwd_torch(scene, state, em_ct, ch_ct, spawn)
        return (d_state if need_state else None, *grads)
    _check_scene(scene, device)
    _check_sel(sel, scene, rays, device)
    out = _level_bwd_launch("raytpu_wf_level_bwd", scene, state, em_ct, ch_ct,
                            spawn, tables, need_state, sel)
    if rays > 0:
        WF_LEVEL_BWD.launches += 1
    return out


def wf_level_bwd_reference(scene, state, em_ct, ch_ct, spawn: bool,
                           tables=None, need_state: bool = True):
    """wf_level_bwd through K4's reference instance, which re-runs the
    brute-force sphere queries instead of reading sel, on a CUDA scene: what
    K4 is held to and timed against.  Not counted in WF_LEVEL_BWD.launches,
    and never on the main path."""
    device = state.device
    _check_scene(scene, device)
    _check_state(state, N_STATE, device, "the ray state")
    _check_state(em_ct, 3, device, "the emission cotangent", state.shape[1])
    return _level_bwd_launch("raytpu_wf_level_bwd_ref", scene, state, em_ct,
                             ch_ct, spawn, tables, need_state, None)


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


def compact_torch(children, pid, cap: int, n_slots: int, return_src: bool = False):
    """K5's plain version.  children (10, 2R) with ray i's children at 2i
    and 2i+1, pid (R,) int32 the parents' slot ids.  Returns (state (10,
    cap), pid (cap,) int32, dropped, n_kept): the live children in order
    in the first n_kept slots with their parents' pids, zero state and pid
    (slot mod n_slots) after them; dropped = max(n_alive - cap, 0) and
    n_kept = min(n_alive, cap) as 0-d int64 tensors.  With `return_src`,
    also src (cap,) int32: the child column each kept slot holds, -1 after
    the kept prefix (what the backward, uncompact, needs)."""
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
    out = (state, out_pid, torch.clamp(total - cap, min=0),
           torch.clamp(total, max=cap))
    if not return_src:
        return out
    src = torch.full((cap,), -1, dtype=torch.int32, device=device)
    src[dest] = torch.nonzero(keep).squeeze(1).to(torch.int32)
    return (*out, src)


def compact(children, pid, cap: int, n_slots: int, return_src: bool = False):
    """compact_torch's function; on CUDA tensors it launches K5 (a count
    kernel, a cumulative sum of the block counts, a scatter kernel) or
    raises.  Without `return_src` the scatter writes no source index."""
    device = children.device
    if device.type == "cpu":
        return compact_torch(children, pid, cap, n_slots, return_src)
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
    src = torch.empty(cap, dtype=torch.int32, device=device) if return_src else None
    if max(kids, cap) > 0:
        err = WF_COMPACT.function("raytpu_wf_scatter")(
            children.data_ptr(), kids, pid.data_ptr(), starts.data_ptr(),
            total.data_ptr(), cap, n_slots, state.data_ptr(),
            out_pid.data_ptr(), src.data_ptr() if return_src else None, dev,
            stream)
        if err != 0:
            raise RuntimeError(f"wf_scatter launch failed: CUDA error {err}")
        WF_COMPACT.launches += 1
    out = (state, out_pid, torch.clamp(total - cap, min=0),
           torch.clamp(total, max=cap))
    return (*out, src) if return_src else out


# --------------------------------------------------------------------------
# K6: the compaction's transpose.


def _check_uncompact(d_state, src, device):
    _check_state(d_state, N_STATE, device, "the state cotangent")
    if src.dim() != 1 or src.shape[0] != d_state.shape[1]:
        raise ValueError(f"src has shape {tuple(src.shape)}; the state "
                         f"cotangent needs one per slot ({d_state.shape[1]})")
    if src.dtype != torch.int32 or src.device != device:
        raise TypeError(f"src must be int32 on {device}, got {src.dtype} on "
                        f"{src.device}")


def uncompact_torch(d_state, src, kids: int):
    """K6's plain version: the (10, kids) cotangent of the children that
    compact(..., return_src=True) read, for the cotangent d_state (10, cap)
    of its state: d_children[f, src[k]] = d_state[f, k] for the 9
    differentiable fields of every kept slot (src[k] >= 0), zero
    elsewhere."""
    out = torch.zeros((N_STATE, kids), dtype=d_state.dtype, device=d_state.device)
    keep = src >= 0
    out[:N_DIFF, src[keep].to(torch.int64)] = d_state[:N_DIFF, keep]
    return out


def uncompact(d_state, src, kids: int):
    """uncompact_torch's function; on CUDA tensors it launches K6 (one
    kernel, no host read) or raises."""
    device = d_state.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"uncompact takes CPU or CUDA tensors, got {device}")
    _check_uncompact(d_state, src, device)
    if device.type == "cpu":
        return uncompact_torch(d_state, src, kids)
    out = torch.empty((N_STATE, kids), dtype=torch.float32, device=device)
    if kids > 0:
        err = WF_UNCOMPACT.function()(
            d_state.data_ptr(), d_state.shape[1], src.data_ptr(), kids,
            out.data_ptr(), device.index or 0,
            torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"wf_uncompact launch failed: CUDA error {err}")
        WF_UNCOMPACT.launches += 1
    return out


# --------------------------------------------------------------------------
# The autograd pairings.


class WfLevelFn(torch.autograd.Function):
    """One level, differentiable: forward K3 (wf_level), backward K4
    (wf_level_bwd), the counterpart of raytpu's _wf_level_ad.  The tensor
    inputs are the three scene tables and the state, so that autograd
    routes the table gradients through scene_tables to the scene leaves.
    It saves its inputs and K3's selections (12 bytes a ray at L <= 32);
    the tables and the BVH are the frame's, shared by every level."""

    @staticmethod
    def forward(ctx, scene, spawn, bvh, spheres_tbl, lights_tbl, bg_tbl, state):
        ctx.scene, ctx.spawn = scene, spawn
        em, children, ctx.sel = wf_level(scene, state, spawn,
                                         (spheres_tbl, lights_tbl, bg_tbl), bvh,
                                         return_sel=True)
        ctx.save_for_backward(spheres_tbl, lights_tbl, bg_tbl, state)
        return (em, children) if spawn else em

    @staticmethod
    def backward(ctx, em_ct, ch_ct=None):
        *tables, state = ctx.saved_tensors
        d_state, *grads = wf_level_bwd(
            ctx.scene, state, em_ct.contiguous(),
            ch_ct.contiguous() if ctx.spawn else None, ctx.spawn,
            tuple(tables), need_state=ctx.needs_input_grad[6], sel=ctx.sel)
        return (None, None, None, *grads, d_state)


class CompactFn(torch.autograd.Function):
    """The compaction, differentiable: forward K5 with its source index,
    backward K6 (uncompact), the counterpart of raytpu's
    _compact_blocked_ad.  It keeps the source index and the child count."""

    @staticmethod
    def forward(ctx, children, pid, cap, n_slots):
        state, out_pid, dropped, n_kept, src = compact(children, pid, cap,
                                                       n_slots, return_src=True)
        ctx.src, ctx.kids = src, children.shape[1]
        ctx.mark_non_differentiable(out_pid, dropped, n_kept)
        return state, out_pid, dropped, n_kept

    @staticmethod
    def backward(ctx, d_state, *_):
        return uncompact(d_state.contiguous(), ctx.src, ctx.kids), None, None, None


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
    over the frame on the device.

    When grad is enabled and a scene leaf requires grad, the frame is
    differentiable: levels run as WfLevelFn (K3 forward, K4 backward) and
    compactions as CompactFn (K5, K6 backward).  A dropped ray then takes
    no gradient: the caller enforces the counter."""
    device = _cuda_device(scene, "render_pixels_wavefront")
    ad = torch.is_grad_enabled() and any(t.requires_grad
                                         for t in scene_leaves(scene))
    tables = bvh = None
    if device.type == "cuda":
        # Every kernel of the port takes max_depth <= kMaxDepth; the
        # wavefront keeps that bound so that every backend takes the same
        # configurations.
        _check_depth(cfg)
        _check_scene(scene, device)
        tables = scene_tables(scene)
        bvh = build_bvh(tables[0], tables[1])
    elif ad:
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
            if ad:
                out = WfLevelFn.apply(scene, spawn, bvh, *tables, state)
                em, children = out if spawn else (out, None)
            else:
                em, children = wf_level(scene, state, spawn, tables, bvh)
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
                step = CompactFn.apply if ad else compact
                state, pid, lost, _ = step(children, pid, min(2 * rays, cap), ws)
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
