"""Per-shard wavefront load at config-5 geometry (the counterpart of
tools/shard_balance.py).

    python -m raytpu_torch.tools.shard_balance [--width 960 --height 540
        --max-depth 6 --alias 1 --spheres 256 --seed 3 --shards 8]
        [--interleave] [--cpu]

Sharded rendering gives each rank a pixel set: a contiguous block
(render_sharded), or with --interleave the strided set {s + k*shards}
(parallel.pixel_set).  The wavefront's live rays per level vary across
the frame, so the ranks can carry unequal loads: the step ends when the
busiest rank ends.  For each shard this tool traces the shard's camera
rays (random_scene(spheres, seed) at the frame's widths) through every
spawning level of the level kernel (K3) and counts the live children of
each level, compacting them (K5) between levels into a capacity of twice
the live parents, which is every child, so that no ray is dropped and the
counts are the true demand.  The shard's pixel index rides through the
compaction as its pid.

It prints each shard's counts on stderr, then raytpu's JSON: for each
level the max and mean over the shards, max_over_mean (the imbalance) and
cap_need_max / cap_need_min (live children per camera ray of the busiest
and idlest shard).  The port adds the card's name and power limit and the
run's kernel launches.  raytpu's tool pads each shard's rays to its
kernel block and duplicates the pids for its tile layout; neither exists
here, and neither changes a count.  Under --cpu the wrappers run their
plain versions.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from raytpu_torch.bench import card_fields, counted
from raytpu_torch.config import RenderConfig
from raytpu_torch.device import local_device
from raytpu_torch.kernels.bvh import build_bvh
from raytpu_torch.kernels.trace_cuda import scene_tables
from raytpu_torch.kernels.wavefront import camera_state, compact, wf_level
from raytpu_torch.scene import random_scene


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--width", type=int, default=960)
    ap.add_argument("--height", type=int, default=540)
    ap.add_argument("--max-depth", type=int, default=6)
    ap.add_argument("--alias", type=int, default=1)
    ap.add_argument("--spheres", type=int, default=256)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--interleave", action="store_true",
                    help="measure the strided pixel-sharding option "
                         "(shard s owns pixels {s + k*shards}) instead "
                         "of contiguous blocks")
    ap.add_argument("--cpu", action="store_true")
    return ap


def shard_live_counts(scene, cfg: RenderConfig, shard_px: int, shards: int,
                      offset: int, interleave: bool, tables, bvh) -> list:
    """The live children of each spawning level for the shard whose first
    pixel is `offset`."""
    device = scene.device
    spp = cfg.samples_per_pixel
    ray = torch.arange(shard_px * spp, dtype=torch.int64, device=device)
    pid, sample = ray // spp, ray % spp
    gp = torch.clamp(offset + pid * (shards if interleave else 1),
                     max=cfg.num_pixels - 1)
    state = camera_state(cfg, gp, sample // cfg.alias_factor,
                         sample % cfg.alias_factor, torch.ones_like(gp, dtype=torch.bool))
    pid = pid.to(torch.int32)
    counts = []
    for _ in range(cfg.max_depth):
        _, children = wf_level(scene, state, True, tables, bvh)
        alive = int((children[6:9] != 0).any(dim=0).sum())
        counts.append(alive)
        state, pid, dropped, kept = compact(children, pid, children.shape[1],
                                            shard_px)
        if int(dropped) != 0 or int(kept) != alive:
            raise RuntimeError(f"the compaction kept {int(kept)} of {alive} live "
                               f"children and dropped {int(dropped)}")
        state, pid = state[:, :alive].contiguous(), pid[:alive]
    return counts


def tool_device(cpu: bool):
    """The CPU under --cpu, else this process's card; None, with the reason
    on stderr, when there is no card: the CPU is never measured in the
    card's place."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print("error: no CUDA device found; pass --cpu to run on the CPU",
              file=sys.stderr)
        return None
    return local_device()


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = tool_device(args.cpu)
    if device is None:
        return 2
    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.max_depth, alias_factor=args.alias)
    scene = random_scene(args.spheres, seed=args.seed, device=device)
    tables = scene_tables(scene)
    bvh = build_bvh(tables[0], tables[1]) if device.type == "cuda" else None
    shard_px = cfg.num_pixels // args.shards
    rays = shard_px * cfg.samples_per_pixel

    def measure():
        per_shard = []
        for s in range(args.shards):
            off = s if args.interleave else s * shard_px
            c = shard_live_counts(scene, cfg, shard_px, args.shards, off,
                                  args.interleave, tables, bvh)
            per_shard.append(c)
            print(f"shard {s}: {c}", file=sys.stderr, flush=True)
        return per_shard

    launches = {}
    per_shard = counted(measure, launches, "shards")

    stats = {}
    for lv, vals in zip(range(1, cfg.max_depth + 1), zip(*per_shard)):
        mx, mn = max(vals), min(vals)
        mean = sum(vals) / len(vals)
        stats[f"L{lv}"] = {
            "max": mx, "mean": round(mean, 1),
            "max_over_mean": round(mx / max(mean, 1), 3),
            "cap_need_max": round(mx / rays, 3),
            "cap_need_min": round(mn / rays, 3),
        }
    out = {"config": f"{args.width}x{args.height} d{cfg.max_depth} "
                     f"N{args.spheres} alias{args.alias}",
           "shards": args.shards, "rays_per_shard": rays,
           "levels": stats, **card_fields(device),
           "launches": launches["shards"]}
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
