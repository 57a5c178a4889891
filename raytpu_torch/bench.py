"""Benchmark harness: one JSON line (the counterpart of bench.py).

    python -m raytpu_torch.bench

Headline: camera Mrays/s of one training step, forward + backward, at
640x480 depth 4 3x3 (BASELINE config 3) through
`loss_and_grad(backend="auto")`, timed on the device between CUDA events.
A "ray" is a camera ray (pixel x alias^2), as in bench.py and
raytpu.render.render_timed.  The line also carries:

  * the forward: `render_timed` on "auto" (`fwd_*`), on the eager tracer
    (`fwd_torch_mrays_per_s`, bench.py's `fwd_jnp_mrays_per_s`: the port
    says torch where raytpu says jnp), and the forward kernel alone
    between CUDA events, the scene's tables built before them
    (`fwd_device_*`).  bench.py takes its device times
    by a slope over K frames in one jit, to cancel a per-dispatch floor of
    its TPU host; this card has no such floor, so the events time one
    call;
  * the step by the host clock after a synchronise (`fwd_bwd_seconds`,
    `wall_fwd_bwd_mrays_per_s`) and between CUDA events (`step_device_*`,
    the headline), with the backend "auto" took (`fwd_bwd_backend`);
  * the golden 800x600 d5 step (`golden_800x600_d5_fwd_bwd_ms`);
  * BASELINE config 5, random_scene(256, seed=3) at 1920x1080 d6, through
    the wavefront and its own capacity ladder
    (`config5_1080p_d6_N256_wavefront_s`, `config5_dropped_rays`);
  * the card (`device`, `power_limit` from nvidia-smi), `backend` (the
    device type) and the frame (`width`, `height`, `depth`, `alias`);
  * `launches`: for each timed key, each main-path kernel's launches in
    its warm-up and runs (trace_fwd K1, trace_bwd K2, wf_level K3,
    wf_compact K5), which show the path each key timed.

Each time is the median of REPS runs after one warm-up (the eager forward:
3 runs, as bench.py), and its runs ride beside it as a `*_times_ms` list:
the same step has read 1.6x apart between processes.

Not ported: bench.py's `est_vpu_mfu`, a share of the TPU v5e's VPU peak,
and its `vs_baseline` denominator, a TPU figure: `vs_baseline` is null.
Nothing falls back: a kernel that fails fails the run, with the error in
the line and a non-zero exit.  Without a card the line says so and the
exit is 1; the CPU is never measured in the card's place.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import sys
import threading
import traceback

import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.device import local_device, nvidia_smi_line
from raytpu_torch.grad import loss_and_grad, resolve_train_backend
from raytpu_torch.kernels.trace_cuda import (TRACE_BWD, TRACE_FWD,
                                             render_pixels_cuda, scene_tables)
from raytpu_torch.kernels.wavefront import (WF_COMPACT, WF_LEVEL,
                                            WF_LEVEL_BWD, WF_UNCOMPACT)
from raytpu_torch.render import render_timed
from raytpu_torch.scene import default_scene, random_scene
from raytpu_torch.utils.profiling import Timer

CONFIG3 = RenderConfig(width=640, height=480, max_depth=4, alias_factor=3)
GOLDEN = RenderConfig(width=800, height=600, max_depth=5, alias_factor=3)
CONFIG5 = RenderConfig(width=1920, height=1080, max_depth=6, alias_factor=3)
CONFIG5_SPHERES = 256
REPS = 5          # timed runs a key, after one warm-up
EAGER_REPS = 3    # the eager forward's, as bench.py's
PROBE_S = 120     # the device probe's watchdog
# The whole run's deadline, past which a hung device prints the failure
# line: a healthy run took 36 s on an NVIDIA H100 80GB HBM3 at 700 W, 25 s
# of it the eager forward's four frames.
DEADLINE_S = 600
# Every kernel of the port, by the names of chip_smoke.py's kernels line,
# and the main path's, whose launches the line counts.
ALL_KERNELS = {"trace_fwd": TRACE_FWD, "trace_bwd": TRACE_BWD,
               "wf_level": WF_LEVEL, "wf_compact": WF_COMPACT,
               "wf_level_bwd": WF_LEVEL_BWD, "wf_uncompact": WF_UNCOMPACT}
KERNELS = {name: ALL_KERNELS[name]
           for name in ("trace_fwd", "trace_bwd", "wf_level", "wf_compact")}


def card_fields(device) -> dict:
    """The card's name and power limit as nvidia-smi prints them ("cpu" and
    None on the CPU)."""
    if device.type != "cuda":
        return {"device": str(device), "power_limit": None}
    return {"device": torch.cuda.get_device_name(device),
            "power_limit": nvidia_smi_line(device).rsplit(",", 1)[1].strip()}


def counted(measure, launches: dict, key: str, kernels: dict = ALL_KERNELS):
    """measure()'s result; each of `kernels`' launches in it go to
    launches[key]."""
    for kernel in kernels.values():
        kernel.launches = 0
    out = measure()
    launches[key] = {name: k.launches for name, k in kernels.items()}
    return out


def timed(fn, timer, reps: int):
    """(seconds of a first call of fn, [seconds of each of `reps` calls
    after it]) by `timer`: Timer() for the host clock, each call's CUDA
    result waited for; Timer(device) for CUDA events on a card."""
    with timer.section("first") as box:
        box["value"] = fn()
    for _ in range(reps):
        with timer.section("run") as box:
            box["value"] = fn()
    times = timer.times()
    return times["first"][0], times["run"]


def ms(times) -> list:
    return [t * 1e3 for t in times]


def metric(cfg: RenderConfig) -> str:
    return (f"Mrays/s/chip fwd+bwd {cfg.width}x{cfg.height} "
            f"depth-{cfg.max_depth} (device step)")


def failure(error: str) -> dict:
    """The honest failure line: no value, and the error."""
    return {"metric": metric(CONFIG3), "value": None, "unit": "Mrays/s",
            "vs_baseline": None, "error": error}


def train_step(scene, cfg: RenderConfig):
    """The training step the bench times, and the backend "auto" takes for
    it: loss_and_grad against a zero target.

    bench.py times raytpu's packed-tile step on the TPU, for the TPU's lane
    layout.  The port's loss_and_grad_packed is loss_and_grad on the
    target's unpacked view, so the flat call is the port of that step."""
    target = torch.zeros((cfg.num_pixels, 3), device=scene.device)
    return ((lambda: loss_and_grad(scene, cfg, target, "auto")),
            resolve_train_backend("auto", scene, cfg))


def run(device, cfg: RenderConfig = CONFIG3, golden: RenderConfig = GOLDEN,
        config5: RenderConfig = CONFIG5,
        config5_spheres: int = CONFIG5_SPHERES) -> dict:
    """Measure the port on `device` at these configs and return the line.
    The device-timed keys (CUDA events) are None on the CPU, where only
    the host clock runs."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    rays = cfg.rays_per_frame
    scene = default_scene(device=device)
    launches = {}

    _, fwd = counted(lambda: render_timed(scene, cfg, warmup=1, iters=REPS),
                     launches, "fwd", KERNELS)
    _, fwd_torch = counted(lambda: render_timed(
        scene, cfg, warmup=1, iters=EAGER_REPS, backend="torch"),
        launches, "fwd_torch", KERNELS)
    fwd_device = None
    if on_card:
        tables = scene_tables(scene)
        fwd_device = counted(lambda: timed(
            lambda: render_pixels_cuda(scene, cfg, tables=tables),
            Timer(device), REPS)[1], launches, "fwd_device", KERNELS)

    step, step_backend = train_step(scene, cfg)
    loss = float(step()[0])
    if not math.isfinite(loss):
        raise RuntimeError(f"the step's loss is {loss}")
    step_wall = counted(lambda: timed(step, Timer(), REPS)[1], launches,
                        "fwd_bwd", KERNELS)
    step_device = (counted(lambda: timed(step, Timer(device), REPS)[1], launches,
                           "step_device", KERNELS) if on_card else None)

    golden_step, _ = train_step(scene, golden)
    golden_wall = counted(lambda: timed(golden_step, Timer(), REPS)[1], launches,
                          "golden_800x600_d5_fwd_bwd", KERNELS)

    s5 = random_scene(config5_spheres, seed=3, device=device)
    _, c5 = counted(lambda: render_timed(s5, config5, warmup=1, iters=REPS,
                                         backend="wavefront"),
                    launches, "config5_1080p_d6_N256_wavefront", KERNELS)

    fwd_s = statistics.median(fwd["times"])
    fwd_bwd_s = statistics.median(step_wall)
    fwd_device_ms = statistics.median(ms(fwd_device)) if on_card else None
    step_device_ms = statistics.median(ms(step_device)) if on_card else None
    step_device_mrays = rays / step_device_ms / 1e3 if on_card else None
    return {
        "metric": metric(cfg),
        "value": step_device_mrays,
        "unit": "Mrays/s",
        "vs_baseline": None,
        "wall_fwd_bwd_mrays_per_s": rays / fwd_bwd_s / 1e6,
        "fwd_mrays_per_s": rays / fwd_s / 1e6,
        "fwd_backend": fwd["backend"],
        "fwd_seconds": fwd_s,
        "fwd_bwd_seconds": fwd_bwd_s,
        "fwd_bwd_backend": step_backend,
        "fwd_torch_mrays_per_s": rays / statistics.median(fwd_torch["times"]) / 1e6,
        "golden_800x600_d5_fwd_bwd_ms": statistics.median(ms(golden_wall)),
        "config5_1080p_d6_N256_wavefront_s": statistics.median(c5["times"]),
        "config5_dropped_rays": c5["dropped"],
        "fwd_device_ms": fwd_device_ms,
        "fwd_device_mrays_per_s": rays / fwd_device_ms / 1e3 if on_card else None,
        "step_device_ms": step_device_ms,
        "step_device_mrays_per_s": step_device_mrays,
        **card_fields(device),
        "backend": device.type,
        "width": cfg.width, "height": cfg.height, "depth": cfg.max_depth,
        "alias": cfg.alias_factor,
        "fwd_times_ms": ms(fwd["times"]),
        "fwd_torch_times_ms": ms(fwd_torch["times"]),
        "fwd_device_times_ms": ms(fwd_device) if on_card else None,
        "fwd_bwd_times_ms": ms(step_wall),
        "step_device_times_ms": ms(step_device) if on_card else None,
        "golden_800x600_d5_fwd_bwd_times_ms": ms(golden_wall),
        "config5_1080p_d6_N256_wavefront_times_ms": ms(c5["times"]),
        "launches": launches,
    }


def probe_device():
    """(this process's card, None), or (None, the reason) when there is no
    card or it does not answer within PROBE_S."""
    found = {}

    def probe():
        try:
            if not torch.cuda.is_available():
                found["error"] = "no CUDA device"
                return
            device = local_device()
            torch.ones(1, device=device).sum().item()
            found["device"] = device
        except Exception as e:  # noqa: BLE001 - reported in the line
            found["error"] = repr(e)

    th = threading.Thread(target=probe, daemon=True)
    th.start()
    th.join(timeout=PROBE_S)
    return found.get("device"), found.get(
        "error", f"device probe timed out after {PROBE_S} s")


def main() -> int:
    """Run the bench at bench.py's sizes on this process's card and print
    its line; without a card, or on any failure, print the failure line
    and return 1."""
    done = threading.Event()

    def deadline():
        if not done.wait(timeout=DEADLINE_S):
            print(json.dumps(failure(f"bench run exceeded its {DEADLINE_S} s "
                                     f"deadline")), flush=True)
            os._exit(1)

    threading.Thread(target=deadline, daemon=True).start()
    try:
        device, error = probe_device()
        if device is None:
            print(json.dumps(failure(error)))
            return 1
        try:
            result = run(device)
        except Exception as e:  # noqa: BLE001 - the run's failure, reported
            traceback.print_exc()
            print(json.dumps(failure(repr(e))))
            return 1
        print(json.dumps(result))
        return 0
    finally:
        done.set()


if __name__ == "__main__":
    sys.exit(main())
