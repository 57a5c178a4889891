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
  * "auto"      — on a CUDA device the wavefront where the measured
                  crossover says so (given the scene and the config),
                  else "cuda"; "torch" on the CPU, as raytpu resolves to
                  jnp off-TPU.

The sharded driver is not ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import warnings

import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.trace import render_image
from raytpu_torch.utils.profiling import Timer

# The "auto" crossover on an NVIDIA H100 80GB HBM3 at 700 W: the wavefront
# where spheres x depth reaches _WF_MIN_WORK.  chip_smoke.py phase 12 at
# 640x480 3x3 with 2M-ray chunks (PERF.md) timed the wavefront
# against K1 in ten cells: it lost at N x d of 128 and less (N=3..64,
# 1.2-8.8x K1's time) and won at 256 and more (N=64..256, 0.40-0.74x).
# raytpu's N x 2^d does not separate them here: N=16 at depth 6 (1024)
# lost 3.0x, N=128 at depth 2 (512) won.  With the 4M-ray chunks below
# the wavefront also won the two cells at 128 (0.86x and 0.94x): this
# bound is on the safe side of them.
_WF_MIN_WORK = 256


def _wf_wins(n_spheres: int, depth: int) -> bool:
    return n_spheres * depth >= _WF_MIN_WORK


# The training step's crossover on the same card (chip_smoke.py phase 15,
# PERF.md): one loss_and_grad step through the differentiable wavefront
# (K3 + K5 forward, K4 + K6 backward, 4M-ray chunks) against the kernel
# pair (K1 + K2), in turns.  At 640x480 3x3 the wavefront won all ten cells
# of the forward's crossover, N x depth from 12 to 1024, at 0.12-0.76x the
# pair's time (default scene at depth 4, config 3's frame: 0.76x), and at
# config 5 0.18x.  Frames below 640x480 3x3 were not measured; there the
# pair stays.
_WF_MIN_TRAIN_RAYS = 640 * 480 * 9


def _wf_wins_train(cfg: RenderConfig) -> bool:
    return cfg.rays_per_frame >= _WF_MIN_TRAIN_RAYS


def resolve_backend(backend: str = "auto", device="cpu", scene=None,
                    cfg: RenderConfig | None = None) -> str:
    """Resolve "auto" to a concrete backend for a scene on `device`.  With
    `scene` and `cfg`, "auto" on a CUDA device takes the measured crossover
    between the dense kernel and the wavefront."""
    device = torch.device(device)
    if backend == "auto":
        if device.type != "cuda":
            return "torch"
        if (scene is not None and cfg is not None
                and _wf_wins(scene.spheres.count, cfg.max_depth)):
            return "wavefront"
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
WF_AUTO_CHUNK = 1 << 22
WF_AUTO_LADDER = (1.0, 1.25, 2.0, 4.0)
# The training step's (the differentiable wavefront, K3 + K5 forward, K4 +
# K6 backward), from chip_smoke.py phase 15's sweep at config 5, factor
# 1.0: 1M-ray chunks 495 ms a step, 2M 466, 4M 450, none dropping, peak
# memory 8.8, 9.0 and 9.9 GiB.  The first rung never dropped there, so the
# ladder is the forward's.
WF_AUTO_CHUNK_TRAIN = 1 << 22
WF_AUTO_LADDER_TRAIN = WF_AUTO_LADDER


def _wf_auto_trials(wf_opts: dict | None, train: bool = False):
    """The wavefront option dicts to try in order: the ladder unless
    wf_opts names a capacity_factor, then exactly that.  `train` takes the
    training step's chunk and ladder."""
    o = dict(wf_opts or {})
    if "capacity_factor" in o:
        return [o]
    o.setdefault("chunk_rays", WF_AUTO_CHUNK_TRAIN if train else WF_AUTO_CHUNK)
    ladder = WF_AUTO_LADDER_TRAIN if train else WF_AUTO_LADDER
    return [dict(o, capacity_factor=c) for c in ladder]


def _warn_escalate(n: int, tried: dict, nxt: dict):
    warnings.warn(
        f"wavefront auto-capacity: {n} live rays dropped at "
        f"capacity_factor={tried['capacity_factor']}; retrying at "
        f"{nxt['capacity_factor']} (the zero-drop capacity depends on the "
        f"scene)", RuntimeWarning, stacklevel=3)


class DroppedRaysError(RuntimeError):
    """Live rays exceeded the wavefront's per-level capacity and were
    dropped: the image is missing their contribution.  Raise the
    capacity_factor (or chunk_rays) until the drop count is zero."""


def _report_drops(dropped, on_drop: str) -> int:
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


def render_single(scene, cfg: RenderConfig, backend: str = "auto",
                  wf_opts: dict | None = None, return_info: bool = False,
                  on_drop: str = "warn"):
    """One-device full-frame render on the scene's device -> (H, W, 3), or
    (image, info) with `return_info`, info = {'dropped': int} and, for the
    wavefront, {'wf_opts': the options that rendered it}.

    `wf_opts` (chunk_rays, capacity_factor, eager_sort) tune the
    wavefront and are ignored by the other backends.  Without a
    capacity_factor the wavefront runs the auto ladder, re-rendering at
    the next capacity on any drop; drops left after it are reported per
    `on_drop` ("warn", "raise" or "ignore")."""
    backend = resolve_backend(backend, scene.device, scene, cfg)
    info = dict(dropped=0)
    if backend == "cuda":
        from raytpu_torch.kernels import render_image_cuda

        img = render_image_cuda(scene, cfg)
    elif backend == "wavefront":
        from raytpu_torch.kernels import render_image_wavefront

        trials = _wf_auto_trials(wf_opts)
        for i, o in enumerate(trials):
            img, info = render_image_wavefront(scene, cfg, return_info=True, **o)
            n = int(info["dropped"])  # the frame's one read of the counter
            if n == 0 or i + 1 == len(trials):
                break
            _warn_escalate(n, o, trials[i + 1])
        # The resolved options ride out, so that a caller rendering more
        # frames of the scene can pass them back and skip the ladder.
        info = dict(dropped=_report_drops(n, on_drop), wf_opts=o)
    else:
        img = render_image(scene, cfg)
    return (img, info) if return_info else img


def render_sharded(*args, **kwargs):
    raise NotImplementedError(
        "the sharded driver is not ported yet (ROADMAP Queue 1 item 7)")


def render_timed(scene, cfg: RenderConfig, warmup: int = 1, iters: int = 3,
                 backend: str = "auto", wf_opts: dict | None = None,
                 on_drop: str = "warn"):
    """Render a scene on a CUDA device and time it with CUDA events on the
    current stream (warm-up excluded), returning (image, stats).  Mrays/s
    counts camera rays (pixels * alias^2); `traced_rays` counts every slot
    of the 2^depth bounce tree; `dropped` is the wavefront's count of lost
    live rays in the last frame (0 on the other backends).  The wavefront's
    warm-up settles its ladder, and the timed frames reuse its options."""
    timer = Timer(scene.device)
    backend = resolve_backend(backend, scene.device, scene, cfg)
    for _ in range(max(warmup, 0)):
        _, info = render_single(scene, cfg, backend, wf_opts, True, on_drop)
        wf_opts = info.get("wf_opts", wf_opts)
    for _ in range(max(iters, 1)):
        with timer.section("render"):
            img, info = render_single(scene, cfg, backend, wf_opts, True,
                                      on_drop)
    times = timer.summary()["render"]
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
        device=torch.cuda.get_device_name(scene.device),
        times=times,
    )
    return img, stats
