"""Command-line driver of the port (the counterpart of raytpu.cli).

Examples:
  python -m raytpu_torch.cli -o out.ppm                # golden 800x600 d5 render
  python -m raytpu_torch.cli --width 640 --height 480 --max-depth 4 --time
  python -m raytpu_torch.cli --scene random --num-spheres 256 -o big.ppm
  python -m raytpu_torch.cli --compare a.ppm b.ppm
  python -m raytpu_torch.cli --list-devices

The scene lives on the first CUDA device, or on the CPU with --cpu;
without --cpu and without a CUDA device the CLI exits 2.  --backend auto
then picks the CUDA kernel or the eager tracer.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

from raytpu_torch.config import RenderConfig

# Flags of raytpu.cli whose path the port does not have yet.
_NOT_PORTED = {
    "sharded": "--sharded: the sharded driver is ROADMAP Queue 1 item 7",
    "interleave": "--interleave: the sharded driver is ROADMAP Queue 1 item 7",
    "oracle": "--oracle: the strict numpy oracle stays in raytpu (ROADMAP "
              "Queue 1, 'Not to port'); run python -m raytpu.cli --oracle",
    "chunk_rays": "--chunk-rays: the wavefront tracer is ROADMAP Queue 1 item 5",
    "capacity_factor": "--capacity-factor: the wavefront tracer is ROADMAP "
                       "Queue 1 item 5",
    "streams": "--streams: the wavefront tracer is ROADMAP Queue 1 item 5",
    "strict_drops": "--strict-drops: the wavefront tracer is ROADMAP Queue 1 item 5",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--width", type=int, default=800)
    p.add_argument("--height", type=int, default=600)
    p.add_argument("--zoom", type=float, default=-4.0)
    p.add_argument("--alias-factor", type=int, default=3)
    p.add_argument("--max-depth", type=int, default=5)
    p.add_argument("--chunk-pixels", type=int, default=8192,
                   help="pixel chunk of the eager tracer (memory bound only)")
    p.add_argument("--scene", choices=["default", "single", "random"],
                   default="default")
    p.add_argument("--scene-file", default=None,
                   help="load the scene from a JSON file; overrides --scene")
    p.add_argument("--save-scene", default=None,
                   help="write the active scene as JSON and continue")
    p.add_argument("--num-spheres", type=int, default=64,
                   help="sphere count for --scene random")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bg-opacity", type=float, default=0.0,
                   help="background-medium opacity (undefined in the "
                        "reference; see raytpu_torch.scene.Medium)")
    p.add_argument("-o", "--output", default=None, help="output PPM path")
    p.add_argument("--time", action="store_true", dest="timeit",
                   help="print timing and Mrays/s as JSON (CUDA device only)")
    p.add_argument("--backend", choices=["auto", "torch", "cuda"],
                   default="auto",
                   help="compute path: the CUDA kernel or the eager tracer "
                        "(auto: cuda on a CUDA device, torch on the CPU)")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (default: the first CUDA device)")
    p.add_argument("--list-devices", action="store_true")
    p.add_argument("--compare", nargs=2, metavar=("A.ppm", "B.ppm"),
                   default=None,
                   help="compare two PPM images and print diff stats as "
                        "JSON; all other options are ignored")
    # Accepted so that raytpu's command lines fail with a clear message.
    for flag in ("--sharded", "--interleave", "--oracle", "--strict-drops"):
        p.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    for flag, kind in (("--chunk-rays", int), ("--capacity-factor", float),
                       ("--streams", int)):
        p.add_argument(flag, type=kind, default=None, help=argparse.SUPPRESS)
    return p


def compare_ppms(path_a: str, path_b: str) -> dict:
    """Byte-level diff stats between two P6 PPMs of one size: byte_exact
    fraction, within-1 fraction, MAE and max over 8-bit channel values,
    and the mismatching-pixel count (as raytpu.cli.compare_ppms)."""
    from raytpu_torch.image import read_ppm

    a = read_ppm(path_a).astype(np.int32)
    b = read_ppm(path_b).astype(np.int32)
    if a.shape != b.shape:
        return {"error": f"size mismatch: {a.shape} vs {b.shape}"}
    diff = np.abs(a - b)
    return {
        "shape": list(a.shape),
        "byte_exact": round(float((diff == 0).mean()), 6),
        "within_1": round(float((diff <= 1).mean()), 6),
        "mae": round(float(diff.mean()), 4),
        "max_abs": int(diff.max()),
        "mismatching_pixels": int((diff.reshape(-1, 3).max(axis=1) > 0).sum()),
        "total_pixels": int(a.shape[0] * a.shape[1]),
    }


def make_scene(args, device):
    from raytpu_torch import scene as S

    if args.scene_file:
        from raytpu_torch.scene_io import load_scene
        return load_scene(args.scene_file, device=device)
    if args.scene == "single":
        built = S.single_sphere_scene(device=device)
    elif args.scene == "random":
        built = S.random_scene(args.num_spheres, seed=args.seed, device=device)
    else:
        built = S.default_scene(device=device)
    # --bg-opacity applies to every generated scene; files carry their own.
    opacity = torch.tensor(args.bg_opacity, dtype=torch.float32, device=device)
    return dataclasses.replace(built, bg=dataclasses.replace(built.bg,
                                                             opacity=opacity))


def describe_devices() -> str:
    lines = ["cpu"]
    for i in range(torch.cuda.device_count()):
        lines.append(f"cuda:{i} {torch.cuda.get_device_name(i)}")
    return "\n".join(lines)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.compare:
        stats = compare_ppms(*args.compare)
        print(json.dumps(stats))
        return 2 if "error" in stats else 0

    for dest, message in _NOT_PORTED.items():
        if getattr(args, dest) not in (None, False):
            print(f"error: {message}", file=sys.stderr)
            return 2

    if args.list_devices:
        print(describe_devices())
        return 0

    if not args.cpu and not torch.cuda.is_available():
        print("error: no CUDA device found; pass --cpu to render on the CPU",
              file=sys.stderr)
        return 2
    cfg = RenderConfig(width=args.width, height=args.height, zoom=args.zoom,
                       alias_factor=args.alias_factor, max_depth=args.max_depth,
                       chunk_pixels=args.chunk_pixels)
    scene = make_scene(args, torch.device("cpu" if args.cpu else "cuda:0"))
    if args.save_scene:
        from raytpu_torch.scene_io import save_scene
        save_scene(scene, args.save_scene)
        print(f"wrote {args.save_scene}")

    from raytpu_torch.render import render_single, render_timed
    if args.timeit:
        if scene.device.type != "cuda":
            print("error: --time measures on a CUDA device; none is available",
                  file=sys.stderr)
            return 2
        img, stats = render_timed(scene, cfg, backend=args.backend)
        print(json.dumps({k: v for k, v in stats.items() if k != "times"}))
    else:
        img = render_single(scene, cfg, backend=args.backend)

    if args.output:
        from raytpu_torch.image import write_ppm
        write_ppm(img.cpu().numpy(), args.output)
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
