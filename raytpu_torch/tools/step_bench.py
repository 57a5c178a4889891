"""Training-step breakdown at BASELINE config 3 (the counterpart of
tools/step_bench.py): the forward kernel alone, the flat step and the
packed-tile step.

    python -m raytpu_torch.tools.step_bench [--width 640] [--height 480]
        [--max-depth 4] [--alias-factor 3] [--cpu]

On the default scene against a zero target:

  * `fwd`: K1 through render_pixels_cuda, summed;
  * `flat_step`: loss_and_grad(backend="cuda"), K1 + the loss + K2;
  * `packed_step`: loss_and_grad_packed on a pack_target target, packed
    once outside the timed calls.

Each is timed as raytpu times it: a first call (`*_compile_s`, which in a
fresh process builds or loads the kernel library), then the fastest of 5
calls (`*_ms`), each by the host clock after the call's CUDA work has
finished.  The differences are raytpu's: `packed_win_ms` = flat - packed,
`nonfwd_flat_ms` and `nonfwd_packed_ms` = step - forward, and
`packed_step_mrays_per_s_wall` counts camera rays.  The port adds each
key's runs (`*_times_ms`), its six kernels' launches over its 6 calls
(`launches`) and the card's name and power limit.  Under --cpu the
wrappers run their plain versions and both steps are autograd of the eager
tracer.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.grad import loss_and_grad, loss_and_grad_packed, pack_target
from raytpu_torch.kernels.trace_cuda import render_pixels_cuda
from raytpu_torch.scene import default_scene
from raytpu_torch.tools.common import (card_fields, counted, ms, timed,
                                       tool_device)
from raytpu_torch.utils.profiling import Timer

REPS = 5  # timed calls after the first, as raytpu's best_of


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--max-depth", type=int, default=4)
    ap.add_argument("--alias-factor", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = tool_device(args.cpu)
    if device is None:
        return 2
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.max_depth, alias_factor=args.alias_factor)
    scene = default_scene(device=device)
    target = torch.zeros((cfg.num_pixels, 3), device=device)
    tpk = pack_target(cfg, target)
    backend = "cuda" if device.type == "cuda" else "torch"
    out, launches = {}, {}

    def run(name, fn):
        first, runs = counted(lambda: timed(fn, Timer(), REPS), launches, name)
        out[name + "_compile_s"] = round(first, 1)
        out[name + "_ms"] = round(min(runs) * 1e3, 2)
        out[name + "_times_ms"] = ms(runs)
        return min(runs)

    t_fwd = run("fwd", lambda: render_pixels_cuda(scene, cfg).sum())
    t_flat = run("flat_step", lambda: loss_and_grad(scene, cfg, target, backend))
    t_packed = run("packed_step", lambda: loss_and_grad_packed(scene, cfg, tpk))

    out["config"] = (f"{args.width}x{args.height} d{args.max_depth} "
                     f"alias{args.alias_factor}")
    out["packed_win_ms"] = round((t_flat - t_packed) * 1e3, 2)
    out["nonfwd_flat_ms"] = round((t_flat - t_fwd) * 1e3, 2)
    out["nonfwd_packed_ms"] = round((t_packed - t_fwd) * 1e3, 2)
    out["packed_step_mrays_per_s_wall"] = round(cfg.rays_per_frame / t_packed / 1e6, 2)
    out.update(card_fields(device), launches=launches)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
