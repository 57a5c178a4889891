"""Per-stage device time of the wavefront's level loop (the counterpart of
tools/wf_breakdown.py).

    python -m raytpu_torch.tools.wf_breakdown [--rays 1048576]
        [--spheres 256] [--seed 3] [--cpu]

At R = --rays seeded rays on random_scene(spheres, seed), it times:

  * `level_spawn_ms`, `level_leaf_ms`: the level kernel (K3) with and
    without children, through the scene's BVH, built once before;
  * `compact_2x_ms`: the compaction (K5) of 2R children into R slots;
  * `scatter_ms`, `scatter_eighth_live_ms`: the emission scatter, the
    `index_add_` of render_pixels_wavefront, of R and of R/8 emissions
    into R/2 pixel slots.

raytpu times each stage by the slope over K calls in one jit, which cancels
its TPU host's dispatch floor.  Here each stage is timed with CUDA events
on the current stream, the median of 5 calls after 1 warm-up, as
chip_smoke.py times its stages; under --cpu by the host clock, on the
plain versions.  The port adds each key's runs (`*_times_ms`), its
kernels' launches (`launches`) and the card's name and power limit.

raytpu's `dup_ms` and `scatter_window_ms` are left out: they time TPU glue
the port does not have.  `_dup_tilewise` copies the pids onto raytpu's
per-tile [refraction | reflection] child layout, while K5 reads one pid a
parent for children 2i and 2i+1; `_scatter_window` folds level 0's
emissions into pixels contiguous modulo the frame, while the port's
pixel-major chunks sum level 0 by a reshape.

The state is raytpu's: ten fields uniform in [-1, 1), from numpy's
default_rng(0).  Field 9 is the medium as a sphere index held in a float;
K3 and its plain version truncate it toward zero, so these values read
sphere 0 or (at exactly -1) the background, never past the table.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys

import numpy as np
import torch

from raytpu_torch.kernels.bvh import build_bvh
from raytpu_torch.kernels.trace_cuda import scene_tables
from raytpu_torch.kernels.wavefront import N_STATE, compact, wf_level
from raytpu_torch.scene import random_scene
from raytpu_torch.tools.common import (card_fields, counted, ms, timed,
                                       tool_device)
from raytpu_torch.utils.profiling import Timer

REPS = 5  # timed calls a stage after one warm-up


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rays", type=int, default=1 << 20)
    ap.add_argument("--spheres", type=int, default=256)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--cpu", action="store_true")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = tool_device(args.cpu)
    if device is None:
        return 2
    r = args.rays
    if r < 8:
        raise SystemExit(f"--rays must be at least 8, got {r}")
    scene = random_scene(args.spheres, seed=args.seed, device=device)
    tables = scene_tables(scene)
    bvh = build_bvh(tables[0], tables[1]) if device.type == "cuda" else None

    rng = np.random.default_rng(0)
    state = torch.from_numpy(
        rng.uniform(-1.0, 1.0, (N_STATE, r)).astype(np.float32)).to(device)
    em = torch.from_numpy(rng.uniform(0.0, 1.0, (3, r)).astype(np.float32)).to(device)
    pid = (torch.arange(r, dtype=torch.int32) % (r // 2)).to(device)
    acc = torch.zeros((3, r // 2), device=device)
    children = torch.cat([state, state], dim=1)
    stages = {
        "level_spawn": lambda: wf_level(scene, state, True, tables, bvh),
        "level_leaf": lambda: wf_level(scene, state, False, tables, bvh),
        "compact_2x": lambda: compact(children, pid, r, r // 2),
        "scatter": lambda: acc.index_add_(1, pid, em),
        "scatter_eighth_live": lambda: acc.index_add_(1, pid[:r // 8], em[:, :r // 8]),
    }

    out = {"rays": r, "spheres": scene.spheres.count,
           "lights": scene.lights.count}
    launches = {}
    for name, fn in stages.items():
        _, runs = counted(lambda: timed(fn, Timer(device), REPS), launches, name)
        out[name + "_ms"] = round(statistics.median(runs) * 1e3, 2)
        out[name + "_times_ms"] = ms(runs)
    out.update(card_fields(device), launches=launches)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
