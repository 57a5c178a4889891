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
    _make_cursor_copy_kernel and the sorts around it): a single-pass
    stable stream compaction (a prefix sum with decoupled look-back) of
    the live children (intensity not all exactly zero) into a static
    capacity, with their pixel slot ids; the slots past the kept prefix
    hold zero state.  Live children past capacity are
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
    compaction's transpose, each child column's cotangent gathered from
    the slot K5 wrote it to (its saved `dst`), exact zeros for the dead
    and dropped children.

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
`compact_mode` and `interpret` have no counterpart (one compaction; no
Pallas interpreter).

The chunk loop is raytpu's scan over `trace_stream`: one function of the
scene tables and the chunk index returns the chunk's slot window and its
drop count, and the strided write into the frame stays outside it.  Under
autograd a frame of more than one chunk runs each chunk but the last
through torch.utils.checkpoint (raytpu's jax.checkpoint of its scan body),
so the backward re-runs those chunks' forwards (K3 and K5 twice a chunk
but the last in a training step) and live memory holds one chunk's
residuals, whatever the frame size: the last chunk's, kept from the
forward, are the first the backward uses and frees.  `streams` > 1 runs
chunk c on CUDA side stream c % streams, so that one chunk's deep, sparse
levels can share the card with another's (on a TPU, which runs one kernel
at a time, the knob measured neutral).

A scene on the CPU runs each kernel's plain version (`wf_level_torch`,
`compact_torch`, `wf_level_bwd_torch`, `uncompact_torch`); a scene on a
CUDA device launches the kernels or raises.  The wavefront takes any depth
(a level is one node, with no stack) and any number of spheres and lights:
K3 and K4 read a scene table too large for shared memory in place.
"""

from __future__ import annotations

import contextlib
import ctypes
import math

import torch
from torch.utils.checkpoint import checkpoint

from raytpu_torch.camera import posed_directions
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels.bvh import Bvh, build_bvh, leaf_count
from raytpu_torch.kernels.trace_cuda import (BG_ROWS, LIGHT_ROWS, SCENE_ROWS,
                                             CudaKernel, _check_scene,
                                             _cuda_device, scene_tables)
from raytpu_torch.ops.geometry import normalize
from raytpu_torch.scene import scene_from_leaves, scene_leaves
from raytpu_torch.trace import _gather_medium, _trace_level, camera_constants
from raytpu_torch.utils import profiling
from raytpu_torch.utils.profiling import scoped, span

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
                                     _p, _i, _p],
             # the instance the entry launches: n_spheres, n_lights, n_leaves
             "raytpu_wf_level_instance": [_i, _i, _i]})

WF_COMPACT = CudaKernel(
    "wf_compact", "wf_compact.cu", "raytpu_wf_compact",
    # children, kids, pid, cap, out, out_pid, dst, scratch, words, device,
    # stream
    [_p, _ll, _p, _ll, _p, _p, _p, _p, _ll, _i, _p],
    # the tail: scratch, cap, n_slots, out, out_pid, device, stream; and the
    # children a tile, which sizes the scratch
    entries={"raytpu_wf_compact_tail": [_p, _ll, _i, _p, _p, _i, _p],
             "raytpu_wf_compact_tile": []})

# scene, n, lights, nl, bg, state, rays, spawn, em_ct, ch_ct, sel, d_state,
# gout, device, stream
_LEVEL_BWD_ARGS = [_p, _i, _p, _i, _p, _p, _ll, _i, _p, _p, _p, _p, _p, _i, _p]
WF_LEVEL_BWD = CudaKernel(
    "wf_level_bwd", "wf_level_bwd.cu", "raytpu_wf_level_bwd", _LEVEL_BWD_ARGS,
    # the reference instance re-running the brute-force queries (sel unread)
    entries={"raytpu_wf_level_bwd_ref": _LEVEL_BWD_ARGS,
             # the instance the entries launch: n_spheres, n_lights
             "raytpu_wf_level_bwd_instance": [_i, _i]})

# The instance of K3 and of K4 that reads the scene table in place from
# global memory (K4's adds every gradient term to the global table).
IN_PLACE = 3

WF_UNCOMPACT = CudaKernel(
    "wf_uncompact", "wf_uncompact.cu", "raytpu_wf_uncompact",
    # d_state, cap, dst, kids, d_children, device, stream
    [_p, _ll, _p, _ll, _p, _i, _p])


def level_instance(n_spheres: int, n_lights: int, backward: bool = False) -> int:
    """The instance K3 (K4 with `backward`) launches for a scene of
    n_spheres spheres and n_lights lights: its C entry's own choice from
    the scene's size, asked of its library (raytpu_wf_level_instance,
    raytpu_wf_level_bwd_instance).  K3: 1, the scene table and
    the tree staged in shared memory; 2, the table alone; 3 (IN_PLACE),
    neither.  K4: 1, the scene table and the block's gradient table
    staged; 2, the scene table alone, every term added to the global
    table; 3 (IN_PLACE), neither."""
    if backward:
        return WF_LEVEL_BWD.function("raytpu_wf_level_bwd_instance")(
            n_spheres, n_lights)
    return WF_LEVEL.function("raytpu_wf_level_instance")(
        n_spheres, n_lights, leaf_count(n_spheres))


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
    (zero intensity) are written as ten zeros, as the kernel writes them.
    Only the live rays are traced: a dead one (intensity exactly zero)
    emits exact zeros and spawns nothing."""
    ems, kids = [], []
    for whole in torch.split(state, PLAIN_RAYS, dim=1):
        idx = torch.nonzero((whole[6:9] != 0).any(dim=0)).squeeze(1)
        part = whole[:, idx]
        rays = part.shape[1]
        mix = part[9]
        matte, ior, opacity = _gather_medium(scene.spheres, scene.bg,
                                             mix.to(torch.int64))
        em, children = _trace_level(scene, part[0:3].T, part[3:6].T,
                                    part[6:9].T, matte, ior, opacity, spawn,
                                    medium_idx=mix)
        ems.append(whole.new_zeros((3, whole.shape[1])).index_copy(1, idx, em.T))
        if spawn:
            origin, direction, intensity, index = children
            # [refraction block | reflection block] -> ray i's at 2i, 2i+1.
            fields = torch.cat([origin.T, direction.T, intensity.T, index[None]])
            fields = fields.reshape(N_STATE, 2, rays).transpose(1, 2)
            alive = (fields[6:9] != 0).any(dim=0)
            fields = torch.where(alive, fields, torch.zeros_like(fields))
            kids.append(whole.new_zeros((N_STATE, whole.shape[1], 2)).index_copy(
                1, idx, fields).reshape(N_STATE, 2 * whole.shape[1]))
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


def _check_bvh(bvh: Bvh, n_spheres: int, device):
    """K3 reads the tree's box rows four columns (16 bytes) a load."""
    boxes, order = bvh.boxes, bvh.order
    if (tuple(boxes.shape) != (6, 2 * bvh.n_leaves) or boxes.dtype != torch.float32
            or tuple(order.shape) != (n_spheres,) or order.dtype != torch.int32):
        raise ValueError(f"the tree has boxes {boxes.dtype} {tuple(boxes.shape)} "
                         f"and order {order.dtype} {tuple(order.shape)}, expected "
                         f"float32 (6, {2 * bvh.n_leaves}) and int32 ({n_spheres},)")
    if boxes.device != device or order.device != device:
        raise ValueError(f"the tree must lie on {device}")
    if not (boxes.is_contiguous() and order.is_contiguous()):
        raise ValueError("the tree's boxes and order must be contiguous")
    if boxes.data_ptr() % 16:
        raise ValueError("the tree's boxes must start on a 16-byte boundary")


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
    _check_scene(scene, device, bounded=False)
    _check_state(state, N_STATE, device, "the ray state")
    em, children, sel = _level_outputs(scene, state, spawn, return_sel)
    rays = state.shape[1]
    if rays == 0:
        return _level_result(em, children, sel, return_sel)
    spheres_tbl, lights_tbl, bg_tbl = tables or scene_tables(scene)
    bvh = bvh or build_bvh(spheres_tbl, lights_tbl)
    _check_bvh(bvh, scene.spheres.count, device)
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
    bit and timed against.  It stages the scene in shared memory, so it
    takes at most MAX_SPHERES spheres and MAX_LIGHTS lights.  Not counted in
    WF_LEVEL.launches, and never on the main path."""
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
    sel); the library picks where the scene and the block's gradient table
    live from their size.  Returns (d_state or None, the three tables)."""
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
            device.index or 0, torch.cuda.current_stream(device).cuda_stream)
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
    _check_scene(scene, device, bounded=False)
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
    _check_scene(scene, device, bounded=False)
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


def compact_torch(children, pid, cap: int, n_slots: int, return_dst: bool = False):
    """K5's plain version.  children (10, 2R) with ray i's children at 2i
    and 2i+1, pid (R,) int32 the parents' slot ids.  Returns (state (10,
    cap), pid (cap,) int32, dropped, n_kept): the live children in order
    in the first n_kept slots with their parents' pids, zero state and pid
    (slot mod n_slots) after them; dropped = max(n_alive - cap, 0) and
    n_kept = min(n_alive, cap) as 0-d int64 tensors.  With `return_dst`,
    also dst (2R,) int32: the slot each child column was written to, -1
    for a dead or dropped child (what the backward, uncompact, needs)."""
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
    if not return_dst:
        return out
    dst = torch.where(keep, rank, -1).to(torch.int32)
    return (*out, dst)


def compact(children, pid, cap: int, n_slots: int, return_dst: bool = False):
    """compact_torch's function; on CUDA tensors it launches K5 (the
    single-pass scan, then the tail kernel, with no host read or PyTorch
    op between them) or raises.  dropped and n_kept are 0-d views of the
    kernels' scratch.  Without `return_dst` the scan writes no destination
    index."""
    device = children.device
    if device.type == "cpu":
        return compact_torch(children, pid, cap, n_slots, return_dst)
    if device.type != "cuda":
        raise ValueError(f"compact takes CPU or CUDA tensors, got {device}")
    _check_compact(children, pid, cap, n_slots, device)
    kids = children.shape[1]
    tile = WF_COMPACT.function("raytpu_wf_compact_tile")()
    # dropped, n_kept, the tiles' ticket and one status word a tile
    scratch = torch.empty(3 + -(-kids // tile), dtype=torch.int64, device=device)
    state = torch.empty((N_STATE, cap), dtype=torch.float32, device=device)
    out_pid = torch.empty(cap, dtype=torch.int32, device=device)
    dst = torch.empty(kids, dtype=torch.int32, device=device) if return_dst else None
    stream = torch.cuda.current_stream(device).cuda_stream
    dev = device.index or 0
    err = WF_COMPACT.function()(
        children.data_ptr(), kids, pid.data_ptr(), cap, state.data_ptr(),
        out_pid.data_ptr(), dst.data_ptr() if return_dst else None,
        scratch.data_ptr(), scratch.numel(), dev, stream)
    if err != 0:
        raise RuntimeError(f"wf_compact launch failed: CUDA error {err}")
    if kids > 0:
        WF_COMPACT.launches += 1
    if cap > 0:
        err = WF_COMPACT.function("raytpu_wf_compact_tail")(
            scratch.data_ptr(), cap, n_slots, state.data_ptr(),
            out_pid.data_ptr(), dev, stream)
        if err != 0:
            raise RuntimeError(f"wf_compact_tail launch failed: CUDA error {err}")
        WF_COMPACT.launches += 1
    out = (state, out_pid, scratch[0], scratch[1])
    return (*out, dst) if return_dst else out


# --------------------------------------------------------------------------
# K6: the compaction's transpose.


def _check_uncompact(d_state, dst, cap: int, device):
    _check_state(d_state, N_STATE, device, "the state cotangent")
    if d_state.shape[1] != cap:
        raise ValueError(f"the state cotangent has {d_state.shape[1]} slots; "
                         f"the compaction kept {cap}")
    if dst.dim() != 1:
        raise ValueError(f"dst has shape {tuple(dst.shape)}; it holds one "
                         f"slot per child column")
    if dst.dtype != torch.int32 or dst.device != device:
        raise TypeError(f"dst must be int32 on {device}, got {dst.dtype} on "
                        f"{dst.device}")


def uncompact_torch(d_state, dst, cap: int):
    """K6's plain version: the (10, kids) cotangent of the children that
    compact(..., cap, return_dst=True) read, for the cotangent d_state
    (10, cap) of its state: d_children[f, j] = d_state[f, dst[j]] for the 9
    differentiable fields of every kept child (dst[j] >= 0), zero
    elsewhere."""
    _check_uncompact(d_state, dst, cap, d_state.device)
    out = torch.zeros((N_STATE, dst.shape[0]), dtype=d_state.dtype,
                      device=d_state.device)
    keep = dst >= 0
    out[:N_DIFF, keep] = d_state[:N_DIFF, dst[keep].to(torch.int64)]
    return out


def uncompact(d_state, dst, cap: int):
    """uncompact_torch's function; on CUDA tensors it launches K6 (one
    gather kernel, no host read) or raises."""
    device = d_state.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"uncompact takes CPU or CUDA tensors, got {device}")
    if device.type == "cpu":
        return uncompact_torch(d_state, dst, cap)
    _check_uncompact(d_state, dst, cap, device)
    kids = dst.shape[0]
    out = torch.empty((N_STATE, kids), dtype=torch.float32, device=device)
    if kids > 0:
        err = WF_UNCOMPACT.function()(
            d_state.data_ptr(), cap, dst.data_ptr(), kids,
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
    It saves its inputs and K3's selections (12 bytes a ray at L <= 32),
    all through save_for_backward, so that a checkpointed chunk (each
    chunk but the last) frees and recomputes them; the tables and the BVH
    are the frame's, shared by every level."""

    @staticmethod
    def forward(ctx, scene, spawn, bvh, spheres_tbl, lights_tbl, bg_tbl, state):
        ctx.scene, ctx.spawn = scene, spawn
        em, children, sel = wf_level(scene, state, spawn,
                                     (spheres_tbl, lights_tbl, bg_tbl), bvh,
                                     return_sel=True)
        ctx.save_for_backward(spheres_tbl, lights_tbl, bg_tbl, state, sel)
        return (em, children) if spawn else em

    @staticmethod
    def backward(ctx, em_ct, ch_ct=None):
        *tables, state, sel = ctx.saved_tensors
        # K4's slots (wf.bwd_slots), and those of its in-place instance.
        rays = state.shape[1]
        profiling.count("wf.bwd_slots", rays)
        if state.is_cuda and profiling.recording() and level_instance(
                ctx.scene.spheres.count, ctx.scene.lights.count,
                backward=True) == IN_PLACE:
            profiling.count("wf.bwd_slots_inplace", rays)
        d_state, *grads = wf_level_bwd(
            ctx.scene, state, em_ct.contiguous(),
            ch_ct.contiguous() if ctx.spawn else None, ctx.spawn,
            tuple(tables), need_state=ctx.needs_input_grad[6], sel=sel)
        return (None, None, None, *grads, d_state)


class CompactFn(torch.autograd.Function):
    """The compaction, differentiable: forward K5 with its destination
    index, backward K6 (uncompact), the counterpart of raytpu's
    _compact_blocked_ad.  It saves the destination index, 4 bytes a
    child, through save_for_backward, and keeps the capacity."""

    @staticmethod
    def forward(ctx, children, pid, cap, n_slots):
        state, out_pid, dropped, n_kept, dst = compact(
            children, pid, cap, n_slots, return_dst=True)
        ctx.save_for_backward(dst)
        ctx.cap = cap
        ctx.mark_non_differentiable(out_pid, dropped, n_kept)
        return state, out_pid, dropped, n_kept

    @staticmethod
    def backward(ctx, d_state, *_):
        (dst,) = ctx.saved_tensors
        return (uncompact(d_state.contiguous(), dst, ctx.cap), None, None, None)


# --------------------------------------------------------------------------
# The orchestration.


def camera_state(cfg: RenderConfig, gp, si, sj, live, view=None):
    """The (10, R) state of camera rays: frame pixel `gp`, supersample
    (si, sj), unit intensity where `live` (else zero), the background
    medium.  Rounds as trace.camera_rays and the kernels' camera_dir.
    With a `view` (camera.View) the rays leave its eye along R^T d, as
    trace.camera_rays poses them."""
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
    if view is None:
        origin = (zero, zero, zero)
    else:
        origin = tuple(torch.full_like(x, float(e)) for e in view.eye)
        d = posed_directions(view, d)
    return torch.stack([*origin, d[:, 0], d[:, 1], d[:, 2],
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
                       npix: int, offset: int = 0, shard_stride: int = 1, *,
                       device, view=None):
    """Chunk c's camera rays, pixel-major and strided: ray j is sample
    j % spp of slot k = j // spp, the window pixel c + k * n_chunks (frame
    pixel offset + that * shard_stride, clamped to P-1), from the posed
    camera `view` where given.  Returns the (10, chunk) state, zero
    intensity past the window, and the slot ids (chunk,) int32."""
    spp = cfg.samples_per_pixel
    ray = torch.arange(chunk, dtype=torch.int64, device=device)
    k, sample = ray // spp, ray % spp
    gpid = c + k * n_chunks
    gp = torch.clamp(offset + torch.clamp(gpid, max=npix - 1) * shard_stride,
                     max=cfg.num_pixels - 1)
    state = camera_state(cfg, gp, sample // cfg.alias_factor,
                         sample % cfg.alias_factor, gpid < npix, view)
    return state, k.to(torch.int32)


def _on(stream):
    """Enter a CUDA stream, or nothing for None (the CPU)."""
    return contextlib.nullcontext() if stream is None else torch.cuda.stream(stream)


# Each device's side streams, made at first use and kept: the caching
# allocator reuses a freed block only on the stream it was allocated on, and
# torch.cuda.Stream() hands out its pool's 32 streams in turn, so streams
# made anew each call would cache a chunk's working set once per pool
# stream.
_SIDE_STREAMS: dict[int, list] = {}


def _side_streams(device, n: int) -> list:
    """n side streams of a CUDA device, the same ones on every call."""
    have = _SIDE_STREAMS.setdefault(device.index or 0, [])
    while len(have) < n:
        have.append(torch.cuda.Stream(device))
    return have[:n]


@scoped("wf.frame")
def render_pixels_wavefront(scene, cfg: RenderConfig, chunk_rays: int = 1 << 18,
                            capacity_factor=2, eager_sort: bool = True,
                            return_info: bool = False, offset: int = 0,
                            count: int | None = None, streams: int = 1,
                            shard_stride: int = 1, view=None,
                            bvh: Bvh | None = None, tables=None):
    """Wavefront render of the `count` frame pixels
    {offset + j*shard_stride : j < count}, clamped to P-1 -> (count, 3)
    linear colour (the full frame by default).

    `chunk_rays` camera rays per chunk bound the live memory;
    `capacity_factor` x chunk is every level's live-ray capacity.
    `eager_sort` compacts at every spawning level; without it a level
    whose children fit the capacity passes them on uncompacted (dead ones
    included).  `streams` independent chunk pipelines: on a CUDA scene
    with streams > 1, chunk c runs on the device's side stream c % streams
    (streams=1 runs on the current stream); on the CPU it changes nothing
    in the frame.  With `return_info` it also returns {'dropped': 0-d
    int64 tensor on the scene's device}, the live rays lost to capacity,
    summed over the frame on the device.

    `view` (a camera.View) poses the camera in the world-space scene;
    None is the reference camera at the origin.  `tables`, the scene's
    scene_tables, and `bvh`, build_bvh's tree over them (whose reach
    covers the view's eye), are the caller's where it has them already,
    as a step that renders several views of one scene does: given a tree,
    the frame builds none.  Tables that the caller made leaves of its own
    take the frame's gradient in place of the scene's leaves.

    When grad is enabled and a scene leaf (or a given table) requires
    grad, the frame is
    differentiable: levels run as WfLevelFn (K3 forward, K4 backward) and
    compactions as CompactFn (K5, K6 backward).  A frame of more than one
    chunk then checkpoints each chunk but the last: the backward re-runs
    their forwards, so autograd holds the per-level residuals of the last
    chunk only, which its backward, the first to run, uses.  It counts
    the frame's chunks (wf.ad_chunks) and those checkpointed
    (wf.recomputed).  A dropped ray takes no gradient: the caller enforces
    the counter, which counts the forward's drops once."""
    device = _cuda_device(scene, "render_pixels_wavefront")
    npix = cfg.num_pixels if count is None else int(count)
    if offset < 0 or shard_stride < 1 or npix < 1 or streams < 1:
        raise ValueError(f"need offset >= 0, shard_stride >= 1, count >= 1 and "
                         f"streams >= 1, got offset={offset} "
                         f"shard_stride={shard_stride} count={npix} "
                         f"streams={streams}")
    if device.type == "cuda":
        _check_scene(scene, device, bounded=False)
    if tables is None:
        tables = scene_tables(scene)
    ad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (*scene_leaves(scene), *tables))
    if bvh is None and device.type == "cuda":
        reach = 0.0 if view is None else float(abs(view.eye).max())
        bvh = build_bvh(tables[0], tables[1], reach)
    # Whether K3 runs its in-place instance, asked only while the profiler
    # records (wf.slots_inplace): with it off the count costs one flag read.
    k3_in_place = (device.type == "cuda" and profiling.recording()
                   and level_instance(scene.spheres.count,
                                      scene.lights.count) == IN_PLACE)
    spp = cfg.samples_per_pixel
    chunk, ws, cap, n_chunks = wavefront_sizes(cfg, chunk_rays, capacity_factor,
                                               npix)
    # The chunks' streams: None for the current one (and on the CPU).
    n_side = min(streams, n_chunks)
    side = (_side_streams(device, n_side) if device.type == "cuda" and n_side > 1
            else [None] * n_side)

    @scoped("wf.chunk")
    def trace_chunk(c, *tables):
        """Chunk c (raytpu's trace_stream): its (3, ws) window of slot sums
        and the live rays it dropped, a 0-d int64 tensor.  It enters its
        own stream, so that a checkpoint's recompute runs there too, and
        keeps nothing outside what it returns and what autograd saves.
        It counts K3's slots a level (wf.slots), those of its in-place
        instance (wf.slots_inplace) and the live rays among them
        (wf.live): the camera rays inside the window at level 0, the
        compaction's kept count after it (a level passed on uncompacted
        counts its slots only)."""
        with _on(side[c % len(side)]):
            state, pid = chunk_camera_state(cfg, chunk, n_chunks, c, npix,
                                            offset, shard_stride, device=device,
                                            view=view)
            window = max(0, min(ws, -(-(npix - c) // n_chunks)))
            profiling.count("wf.live", spp * window)
            lost = torch.zeros((), dtype=torch.int64, device=device)
            for level in range(cfg.max_depth + 1):
                with span("wf.level"):
                    spawn = level < cfg.max_depth
                    profiling.count("wf.slots", state.shape[1])
                    if k3_in_place:
                        profiling.count("wf.slots_inplace", state.shape[1])
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
                        state, pid, n, kept = step(children, pid,
                                                   min(2 * rays, cap), ws)
                        lost = lost + n
                        profiling.count("wf.live", kept)
            return accw, lost

    acc = torch.zeros((3, npix), dtype=torch.float32, device=device)
    drops = [torch.zeros((), dtype=torch.int64, device=device) for _ in side]
    forked = side[0] is not None
    if forked:
        # The side streams start after the tables, the BVH, acc and the
        # counters exist; each of those is read or written there, so the
        # allocator must not hand its memory on before their work ends.
        here = torch.cuda.current_stream(device)
        for s in side:
            s.wait_stream(here)
            for t in (*tables, bvh.boxes, bvh.order, acc, *drops):
                t.record_stream(s)
    for c in range(n_chunks):
        s = c % len(side)
        # Every chunk but the last goes through a checkpoint.  The backward
        # reaches the last chunk first, so a recompute of it would rebuild
        # at once the residuals it frees now: keeping them costs no peak.
        recompute = ad and c < n_chunks - 1
        if ad:
            profiling.count("wf.ad_chunks")
            if recompute:
                profiling.count("wf.recomputed")
        with _on(side[s]):
            if recompute:
                accw, lost = checkpoint(trace_chunk, c, *tables,
                                        use_reentrant=False,
                                        preserve_rng_state=False)
            else:
                accw, lost = trace_chunk(c, *tables)
            # Slot k of chunk c is window pixel c + k * n_chunks.
            mine = acc[:, c::n_chunks]
            mine.copy_(accw[:, :mine.shape[1]])
            drops[s] += lost
    if forked:
        for s in side:
            here.wait_stream(s)
    dropped = torch.stack(drops).sum()
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
