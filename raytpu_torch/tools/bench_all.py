"""Measure every BASELINE config on this process's card and print a JSON
line per config (the counterpart of tools/bench_all.py).

    python -m raytpu_torch.tools.bench_all [--skip-large] [--cpu]

The configs are raytpu's five with raytpu's scenes (configs()): config 1
(64x64 d0 1x1, single_sphere_scene()), config 2 (320x240 d2), config 3
(640x480 d4) and the golden frame (800x600 d5), each on default_scene(),
and, unless --skip-large, config 5: 1920x1080 d6 on
random_scene(256, num_lights=4) at seed 0 (raytpu_torch.bench and
chip_smoke.py take seed 3).  Each row holds raytpu's keys:

  * `fwd_ms`, `fwd_mrays_s`: the dense forward kernel (K1) through
    render_image_cuda, every config;
  * where "auto" renders the scene through the wavefront on a card
    (render.card_backend), the wavefront frame (K3, K5) at WF_AUTO_CHUNK
    and the ladder's first rung, one attempt a frame (a drop is counted,
    not retried): `fwd_wavefront_ms`, `fwd_wavefront_mrays_s`,
    `wavefront_dropped`;
  * the training step against a zero target: where "auto" trains through
    the wavefront on a card (grad.card_train_backend),
    loss_and_grad_wavefront at its defaults (K3-K6, each chunk
    checkpointed; `fwd_bwd_wavefront_dropped`, `fwd_bwd_wavefront_ms`,
    `fwd_bwd_wavefront_mrays_s`), else, where the kernel pair takes the
    spheres (N <= MAX_SPHERES), loss_and_grad on K1 + K2 (`fwd_bwd_ms`,
    `fwd_bwd_mrays_s`).

raytpu picks the wavefront where N >= 128 and depth >= 4 and the kernel
pair where N <= its BWD_MAX_SPHERES; the port's rules, measured on the
card, pick the same paths on these five configs.  A drop at seed 0 is a
finding about the ladder's first rung, not a failure of the tool.

Each time is raytpu's statistic: one call, then the fastest of REPS calls
(STEP_REPS for the wavefront step), each by the host clock after the
call's CUDA work has finished; Mrays/s count camera rays.  The port adds
each key's runs (`*_times_ms`), each key's launches of the six kernels
over all its calls, the drop count's call and the first call included
(`launches`), and the card's name and power limit.  A stage that raises
writes raytpu's `fwd_error`, `wavefront_error` or `bwd_error` into its
row; main then exits 1 after the last row, so that a failed kernel never
reads as a pass.  Under --cpu each wrapper runs its kernel's plain version
(the steps autograd of the eager tracer) on the card's paths.
"""

from __future__ import annotations

import argparse
import json
import sys
import traceback

import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.grad import (card_train_backend, loss_and_grad,
                               loss_and_grad_wavefront)
from raytpu_torch.kernels.trace_cuda import MAX_SPHERES, render_image_cuda
from raytpu_torch.kernels.wavefront import render_image_wavefront
from raytpu_torch.render import WF_AUTO_CHUNK, WF_AUTO_LADDER, card_backend
from raytpu_torch.scene import default_scene, random_scene, single_sphere_scene
from raytpu_torch.tools.common import (card_fields, counted, ms, timed,
                                       tool_device)
from raytpu_torch.utils.profiling import Timer

REPS = 3        # timed calls a key after its first, as raytpu's bench()
STEP_REPS = 1   # the wavefront step's
WAVEFRONT_OPTS = dict(chunk_rays=WF_AUTO_CHUNK, capacity_factor=WF_AUTO_LADDER[0])


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--skip-large", action="store_true")
    ap.add_argument("--cpu", action="store_true")
    return ap


def configs(skip_large: bool, device) -> list:
    """[(name, scene on `device`, RenderConfig)], raytpu's list."""
    out = [
        ("config1", single_sphere_scene(device=device),
         RenderConfig(width=64, height=64, max_depth=0, alias_factor=1)),
        ("config2", default_scene(device=device),
         RenderConfig(width=320, height=240, max_depth=2)),
        ("config3", default_scene(device=device),
         RenderConfig(width=640, height=480, max_depth=4)),
        ("golden", default_scene(device=device),
         RenderConfig(width=800, height=600, max_depth=5)),
    ]
    if not skip_large:
        out.append(("config5", random_scene(256, num_lights=4, device=device),
                    RenderConfig(width=1920, height=1080, max_depth=6)))
    return out


def paths(scene, cfg: RenderConfig):
    """(whether the row times the wavefront frame, the step's backend:
    "wavefront", "cuda" or None), by the port's rules on a card."""
    if card_train_backend(scene, cfg) == "wavefront":
        step = "wavefront"
    else:
        step = "cuda" if scene.spheres.count <= MAX_SPHERES else None
    return card_backend(scene, cfg) == "wavefront", step


def _error(e: Exception) -> str:
    traceback.print_exc()
    return f"{type(e).__name__}: {str(e)[:120]}"


def _put(row: dict, key: str, runs, rays: int):
    dt = min(runs)
    row[f"{key}_ms"] = round(dt * 1e3, 2)
    row[f"{key}_mrays_s"] = round(rays / dt / 1e6, 1)
    row[f"{key}_times_ms"] = ms(runs)


def row(name: str, scene, cfg: RenderConfig) -> dict:
    """One config's row on the scene's device (without the card's name)."""
    rays = cfg.rays_per_frame
    out = {"config": name, "width": cfg.width, "height": cfg.height,
           "depth": cfg.max_depth, "alias": cfg.alias_factor,
           "spheres": scene.spheres.count}
    launches = {}
    frame_wavefront, step = paths(scene, cfg)
    try:
        _, runs = counted(lambda: timed(lambda: render_image_cuda(scene, cfg),
                                        Timer(), REPS), launches, "fwd")
        _put(out, "fwd", runs, rays)
    except Exception as e:  # noqa: BLE001 - written into the row
        out["fwd_error"] = _error(e)
    if frame_wavefront:
        def frame():
            return render_image_wavefront(scene, cfg, return_info=True,
                                          **WAVEFRONT_OPTS)

        try:
            drops, (_, runs) = counted(
                lambda: (int(frame()[1]["dropped"]), timed(frame, Timer(), REPS)),
                launches, "fwd_wavefront")
            _put(out, "fwd_wavefront", runs, rays)
            out["wavefront_dropped"] = drops
        except Exception as e:  # noqa: BLE001 - written into the row
            out["wavefront_error"] = _error(e)
    target = torch.zeros((cfg.num_pixels, 3), device=scene.device)
    if step == "wavefront":
        def wf_step():
            return loss_and_grad_wavefront(scene, cfg, target, on_drop="ignore",
                                           return_info=True)

        try:
            drops, (_, runs) = counted(
                lambda: (wf_step()[2]["dropped"], timed(wf_step, Timer(), STEP_REPS)),
                launches, "fwd_bwd_wavefront")
            out["fwd_bwd_wavefront_dropped"] = drops
            _put(out, "fwd_bwd_wavefront", runs, rays)
        except Exception as e:  # noqa: BLE001 - written into the row
            out["bwd_error"] = _error(e)
    elif step == "cuda":
        backend = "cuda" if scene.device.type == "cuda" else "torch"
        try:
            _, runs = counted(lambda: timed(
                lambda: loss_and_grad(scene, cfg, target, backend), Timer(), REPS),
                launches, "fwd_bwd")
            _put(out, "fwd_bwd", runs, rays)
        except Exception as e:  # noqa: BLE001 - written into the row
            out["bwd_error"] = _error(e)
    out["launches"] = launches
    return out


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = tool_device(args.cpu)
    if device is None:
        return 2
    card = card_fields(device)
    failed = False
    for name, scene, cfg in configs(args.skip_large, device):
        line = {**row(name, scene, cfg), **card}
        print(json.dumps(line), flush=True)
        failed |= any(key.endswith("_error") for key in line)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
