"""Render drivers: backend choice, one-device render, timing on the card
(the counterpart of raytpu.render).

Backends:
  * "torch"     — the eager tracer (raytpu_torch.trace), on any device.
  * "cuda"      — the fused forward kernel (kernels.trace_cuda), on a CUDA
                  device only.
  * "wavefront" — per-level kernels and live-ray compaction
                  (kernels.wavefront); on the CPU their plain versions.
                  It can drop live rays past its per-level capacity, and
                  counts them.
  * "auto"      — on a CUDA device the wavefront where the dense kernel
                  does not take the scene (a depth above its stack's
                  MAX_DEPTH, more than MAX_SPHERES spheres or MAX_LIGHTS
                  lights) or where the measured crossover says so (given
                  the scene and the config), else "cuda"; "torch" on the
                  CPU, as raytpu resolves to jnp off-TPU.

The card's path rules live here, for rendering (card_backend) and for
training (card_train_backend, which raytpu_torch.grad resolves through),
beside the wavefront's auto chunk, its capacity ladder and the climb up it
(climb_ladder) that render_sharded and grad.fit_scene both run.

render_sharded renders the frame over the ranks of a process group
(raytpu_torch.parallel): the scene replicated, each rank its pixel set,
the frame gathered on every rank.
"""

from __future__ import annotations

import warnings

import torch

from raytpu_torch.camera import scene_in_view
from raytpu_torch.config import RenderConfig
from raytpu_torch.device import resolve_device
from raytpu_torch.kernels.trace_cuda import (bwd_takes, dense_takes,
                                             render_pixels_cuda,
                                             render_pixels_torch)
from raytpu_torch.kernels.wavefront import render_pixels_wavefront
from raytpu_torch.parallel.mesh import (Mesh, all_gather_rows, all_reduce_sum,
                                        interleaved, make_mesh, pixel_set)
from raytpu_torch.utils.profiling import Timer, scoped

# The "auto" crossover on an NVIDIA H100 80GB HBM3 at 700 W: the wavefront
# where spheres x depth reaches _WF_MIN_WORK.  chip_smoke.py phase 12 at
# 640x480 3x3 with 4M-ray chunks (PERF.md) times the wavefront against K1
# in ten cells.  Since K1 traces a thread a camera sample, K1 wins
# every cell of N x d 384 and less (N=3..128, 1.12-38x K1's time; N=128 d2
# 1.12x, N=64 d4 1.81x, N=64 d6 1.73x) and the wavefront the two of 512
# and more (N=256 d2 0.62x, d4 0.50x) and config 5 (0.65x).  With the
# previous K1 (a thread a pixel) the split was at 256; N x d between 384
# and 512 is not measured.  raytpu's N x 2^d does not separate the cells:
# N=16 at depth 6 (1024) loses 13x.
_WF_MIN_WORK = 512


def _wf_wins(n_spheres: int, depth: int) -> bool:
    return n_spheres * depth >= _WF_MIN_WORK


# The training step's crossover on the same card (chip_smoke.py phase 15,
# PERF.md): one loss_and_grad step through the differentiable wavefront
# (K3 + K5 forward, K4 + K6 backward, 4M-ray chunks) against the kernel
# pair (K1 + K2, K2 a tree a camera sample), in turns, at 640x480 3x3.
# The pair won the cells of N x depth 128 and less (N=3 d4, config 3's: the
# wavefront 4.7-5.3x the pair's time over three reads; N=16 d4 3.8x, d6
# 4.2x; N=64 d2 1.65x, N=32 d4 1.78x), and the wavefront won 256 and more
# (0.25-0.81x) and config 5 (0.32x).  Frames below 640x480 3x3 were not
# measured; there the pair stays.
_WF_MIN_TRAIN_RAYS = 640 * 480 * 9
_WF_MIN_TRAIN_WORK = 256


def _wf_wins_train(n_spheres: int, cfg: RenderConfig) -> bool:
    return (cfg.rays_per_frame >= _WF_MIN_TRAIN_RAYS
            and n_spheres * cfg.max_depth >= _WF_MIN_TRAIN_WORK)


def card_backend(scene, cfg: RenderConfig) -> str:
    """What "auto" renders `scene` at `cfg` through on a CUDA device,
    wherever the scene lies: the wavefront where the dense kernel does not
    take the scene at that depth (at any depth, 0 included) or where the
    measured crossover says so, else "cuda"."""
    if not dense_takes(scene, cfg) or _wf_wins(scene.spheres.count,
                                               cfg.max_depth):
        return "wavefront"
    return "cuda"


def card_train_backend(scene, cfg: RenderConfig) -> str:
    """What "auto" trains `scene` at `cfg` through on a CUDA device,
    wherever the scene lies: the wavefront where the kernel pair does not
    take the scene (a depth above MAX_DEPTH, more than MAX_SPHERES spheres
    or MAX_LIGHTS lights, or tables beyond the backward's shared memory)
    or where the measured training crossover says so, else "cuda"."""
    n, nl = scene.spheres.count, scene.lights.count
    if (not dense_takes(scene, cfg) or not bwd_takes(n, nl)
            or _wf_wins_train(n, cfg)):
        return "wavefront"
    return "cuda"


def resolve_backend(backend: str = "auto", scene=None,
                    cfg: RenderConfig | None = None, device=None) -> str:
    """Resolve "auto" to a concrete backend for a scene on its device (or,
    without a scene, on `device`, default this process's card, which
    raises without one).  With `scene` and `cfg`, "auto" on a CUDA device
    is card_backend's choice.  An explicit "cuda" is kept: its kernel
    raises on what it does not take."""
    device = scene.device if scene is not None else resolve_device(device)
    if backend == "auto":
        if device.type != "cuda":
            return "torch"
        if scene is not None and cfg is not None:
            return card_backend(scene, cfg)
        return "cuda"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend 'cuda' needs a scene on a CUDA device, "
                         f"got {device}")
    if backend not in ("torch", "cuda", "wavefront"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


# The wavefront's auto-capacity ladder on an NVIDIA H100 80GB HBM3 at 700 W
# (chip_smoke.py phase 12's sweep at config 5, PERF.md): chunk_rays
# camera rays per chunk, and the capacity factors tried in order, escalating
# on any drop.  Rendering is stateless, so a retry is exact.  An explicit
# capacity_factor in wf_opts is one attempt.  The sweep: larger chunks
# were faster (256K 272 ms, 512K 237, 1M 213, 2M 199, 4M 192 at factor
# 1.0), and the factor moved the time by ~1% while 0.875 dropped rays at
# 256K-1M; 1.0 dropped none.
# The training step's (the differentiable wavefront, K3 + K5 forward, K4 +
# K6 backward, each chunk but the last checkpointed so that its backward
# re-runs its K3 + K5 forward; every chunk was when swept), from
# chip_smoke.py phase 15's sweep at config 5, factor 1.0, on the same
# card: 1M-ray chunks 329.5 ms a step, 2M 298.7, 4M 287.0, none
# dropping; the peak, one chunk's residuals, 2.38, 2.96 and
# 4.10 GiB with the ~1.7 GiB the script held before the step (phase 21
# reads 2.44 GiB for the 4M step alone).  The first rung never dropped
# there, so training takes the forward's chunk and ladder.
WF_AUTO_CHUNK = 1 << 22
WF_AUTO_LADDER = (1.0, 1.25, 2.0, 4.0)
# A single wavefront training call's capacity when the caller names none:
# raytpu's loss_and_grad_wavefront default, above every measured frontier.
# fit_scene climbs the ladder instead.
WF_TRAIN_CAPACITY = 2.0


def wf_rungs(wf_opts: dict | None) -> list:
    """The wavefront option dicts to try in order: wf_opts alone where it
    names a capacity_factor (a render then takes render_pixels_wavefront's
    own chunk unless it names chunk_rays, a training step WF_AUTO_CHUNK),
    else the ladder's factors over wf_opts, chunk_rays WF_AUTO_CHUNK
    unless it names one."""
    o = dict(wf_opts or {})
    if "capacity_factor" in o:
        return [o]
    o.setdefault("chunk_rays", WF_AUTO_CHUNK)
    return [dict(o, capacity_factor=c) for c in WF_AUTO_LADDER]


class DroppedRaysError(RuntimeError):
    """Live rays exceeded the wavefront's per-level capacity and were
    dropped: the image is missing their contribution.  Raise the
    capacity_factor (or chunk_rays) until the drop count is zero."""


def report_drops(dropped, on_drop: str) -> int:
    """The drop count as an int, reported per `on_drop`: "warn"
    (default), "raise" or "ignore"."""
    n = int(dropped)
    if n > 0 and on_drop == "raise":
        raise DroppedRaysError(
            f"wavefront dropped {n} live rays (per-level capacity "
            f"overflow); increase capacity_factor or chunk_rays")
    if n > 0 and on_drop == "warn":
        warnings.warn(
            f"wavefront dropped {n} live rays (per-level capacity "
            f"overflow): the image is missing their light; increase "
            f"capacity_factor or chunk_rays", RuntimeWarning, stacklevel=3)
    return n


def climb_ladder(rungs: list, attempt, start: int = 0, on_drop: str = "warn"):
    """Climb the capacity ladder `rungs` from rung `start`: attempt(rung)
    returns (a result, its drop count as an int); on a drop below the top
    rung it warns and attempts the next rung, and the drops left at the top
    (or at a ladder of one) are reported per `on_drop`.  Returns (the last
    result, the drops left, the index of the rung it ended on)."""
    i = start
    while True:
        result, n = attempt(rungs[i])
        if n == 0 or i + 1 == len(rungs):
            return result, report_drops(n, on_drop), i
        warnings.warn(
            f"wavefront auto-capacity: {n} live rays dropped at "
            f"capacity_factor={rungs[i]['capacity_factor']}; retrying at "
            f"{rungs[i + 1]['capacity_factor']} (the zero-drop capacity "
            f"depends on the scene)", RuntimeWarning, stacklevel=3)
        i += 1


def render_single(scene, cfg: RenderConfig, backend: str = "auto",
                  wf_opts: dict | None = None, return_info: bool = False,
                  on_drop: str = "warn", view=None):
    """One-device full-frame render on the scene's device -> (H, W, 3), or
    (image, info) with `return_info`, info = {'dropped': int} and, for the
    wavefront, {'wf_opts': the options that rendered it}.

    `wf_opts` (chunk_rays, capacity_factor, streams, eager_sort) tune the
    wavefront and are ignored by the other backends.  Without a
    capacity_factor the wavefront runs the auto ladder, re-rendering at
    the next capacity on any drop; drops left after it are reported per
    `on_drop` ("warn", "raise" or "ignore").  `view` (a camera.View) poses
    the camera in the world-space scene, as in render_sharded.
    render_sharded over a world of one, whatever process group is
    initialised."""
    return render_sharded(scene, cfg, Mesh(0, 1, scene.device), backend,
                          wf_opts, return_info, on_drop, view=view)


@scoped("render.frame")
def render_sharded(scene, cfg: RenderConfig, mesh=None, backend: str = "auto",
                   wf_opts: dict | None = None, return_info: bool = False,
                   on_drop: str = "warn", interleave: bool | None = None,
                   view=None):
    """Render the frame with its pixels split over the ranks of `mesh`
    (default: make_mesh on the scene's device) -> (H, W, 3) on every rank,
    on the scene's device; with `return_info`, (image, info) as
    render_single's, the drops summed over the ranks.

    Each rank renders its pixel set (parallel.pixel_set): by default (None)
    the strided set {rank + j*size}, which spreads a hot strip over the
    ranks so that none waits for the busiest block, or with `interleave`
    False a block.  Any P works: the last set's tail repeats pixel P-1 and
    is cut off.  Pixels are independent, so the frame is the one-device
    frame.  The wavefront's ladder climbs on the drops summed over the
    ranks, read once a rung, so that every rank takes the same rung, and
    drops left are reported per `on_drop` on every rank.

    `view` (a camera.View) renders the world-space scene from that posed
    camera: the kernel K1, whose camera rays are made in the kernel, takes
    the scene moved into the view (camera.scene_in_view), the others the
    posed rays; None is the reference camera."""
    mesh = make_mesh(scene.device) if mesh is None else mesh
    backend = resolve_backend(backend, scene, cfg)
    offset, count, stride = pixel_set(mesh, cfg, interleave)
    info = dict(dropped=0)
    if backend == "cuda":
        posed = scene if view is None else scene_in_view(scene, view)
        rows = render_pixels_cuda(posed, cfg, offset, count, stride)
    elif backend == "wavefront":
        def attempt(o):
            rows, mine = render_pixels_wavefront(
                scene, cfg, return_info=True, offset=offset, count=count,
                shard_stride=stride, view=view, **o)
            return rows, int(all_reduce_sum(mesh, mine["dropped"]))  # one read a rung

        rungs = wf_rungs(wf_opts)
        rows, n, i = climb_ladder(rungs, attempt, on_drop=on_drop)
        # The resolved options ride out, so that a caller rendering more
        # frames of the scene can pass them back and skip the ladder.
        info = dict(dropped=n, wf_opts=rungs[i])
    else:
        rows = render_pixels_torch(scene, cfg, offset, count, stride, view=view)
    out = all_gather_rows(mesh, rows)
    if stride > 1:
        # Row s*count + j holds pixel s + j*size: the transpose puts pixel
        # q at row q (the repeated tail lands past P).
        out = out.reshape(mesh.size, count, 3).transpose(0, 1).reshape(-1, 3)
    img = out[:cfg.num_pixels].reshape(cfg.height, cfg.width, 3)
    return (img, info) if return_info else img


def render_timed(scene, cfg: RenderConfig, mesh=None, warmup: int = 1,
                 iters: int = 3, backend: str = "auto",
                 wf_opts: dict | None = None, on_drop: str = "warn",
                 interleave: bool | None = None):
    """Render a scene and time it (warm-up excluded), returning (image,
    stats).  On a card each frame is timed with CUDA events on the current
    stream, on the CPU by the host clock.  Mrays/s counts camera rays
    (pixels * alias^2); `traced_rays` counts every slot of the 2^depth
    bounce tree; `seconds` is the fastest frame and `times` every frame's;
    `dropped` is the wavefront's count of lost live rays in the last frame
    (0 on the other backends).  The wavefront's warm-up settles its
    ladder, and the timed frames reuse its options.  With `mesh`, the
    frame is render_sharded's over it (`interleave` as there), its gather
    included; `ranks` counts them (1 without), and `interleave` says
    whether their sets were interleaved.  `device` names the card,
    or the CPU."""
    timer = Timer(scene.device)
    backend = resolve_backend(backend, scene, cfg)
    mesh = Mesh(0, 1, scene.device) if mesh is None else mesh
    for _ in range(max(warmup, 0)):
        _, info = render_sharded(scene, cfg, mesh, backend, wf_opts, True,
                                 on_drop, interleave)
        wf_opts = info.get("wf_opts", wf_opts)
    for _ in range(max(iters, 1)):
        with timer.section("render"):
            img, info = render_sharded(scene, cfg, mesh, backend, wf_opts,
                                       True, on_drop, interleave)
    times = timer.times()["render"]
    dt = min(times)
    primary = cfg.rays_per_frame
    tree = (2 ** (cfg.max_depth + 1) - 1) * primary
    stats = dict(
        seconds=dt,
        primary_rays=primary,
        traced_rays=tree,
        mrays_per_s=primary / dt / 1e6,
        traced_mrays_per_s=tree / dt / 1e6,
        backend=backend,
        dropped=info["dropped"],
        times=times,
        device=(torch.cuda.get_device_name(scene.device)
                if scene.device.type == "cuda" else str(scene.device)),
        ranks=mesh.size,
        interleave=interleaved(mesh, interleave),
    )
    return img, stats
