"""Render drivers: backend choice, one-device render, timing on the card
(the counterpart of raytpu.render).

Backends:
  * "torch" — the eager tracer (raytpu_torch.trace), on any device.
  * "cuda"  — the fused forward kernel (raytpu_torch.kernels), on a CUDA
              device only.
  * "auto"  — "cuda" for a scene on a CUDA device, "torch" on the CPU, as
              raytpu resolves to its kernel on a TPU and to jnp elsewhere.

The wavefront tracer and the sharded driver are not ported yet (ROADMAP
Queue 1 items 5 and 7).
"""

from __future__ import annotations

import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.trace import render_image
from raytpu_torch.utils.profiling import Timer


def resolve_backend(backend: str = "auto", device="cpu") -> str:
    """Resolve "auto" to a concrete backend for a scene on `device`."""
    device = torch.device(device)
    if backend == "wavefront":
        raise NotImplementedError(
            "the wavefront tracer is not ported yet (ROADMAP Queue 1 item 5)")
    if backend == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if backend == "cuda" and device.type != "cuda":
        raise ValueError(f"backend 'cuda' needs a scene on a CUDA device, "
                         f"got {device}")
    if backend not in ("torch", "cuda"):
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def render_single(scene, cfg: RenderConfig, backend: str = "auto"):
    """One-device full-frame render on the scene's device -> (H, W, 3)."""
    if resolve_backend(backend, scene.device) == "cuda":
        from raytpu_torch.kernels import render_image_cuda

        return render_image_cuda(scene, cfg)
    return render_image(scene, cfg)


def render_sharded(*args, **kwargs):
    raise NotImplementedError(
        "the sharded driver is not ported yet (ROADMAP Queue 1 item 7)")


def render_timed(scene, cfg: RenderConfig, warmup: int = 1, iters: int = 3,
                 backend: str = "auto"):
    """Render a scene on a CUDA device and time it with CUDA events on the
    current stream (warm-up excluded), returning (image, stats).  Mrays/s
    counts camera rays (pixels * alias^2); `traced_rays` counts every slot
    of the 2^depth bounce tree."""
    timer = Timer(scene.device)
    backend = resolve_backend(backend, scene.device)
    for _ in range(max(warmup, 0)):
        render_single(scene, cfg, backend)
    for _ in range(max(iters, 1)):
        with timer.section("render"):
            img = render_single(scene, cfg, backend)
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
        device=torch.cuda.get_device_name(scene.device),
        times=times,
    )
    return img, stats
