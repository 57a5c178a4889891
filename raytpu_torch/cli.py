"""Command-line driver of the port (the counterpart of raytpu.cli).

Examples:
  python -m raytpu_torch.cli -o out.ppm                # golden 800x600 d5 render
  python -m raytpu_torch.cli --width 640 --height 480 --max-depth 4 --time
  python -m raytpu_torch.cli --scene random --num-spheres 256 -o big.ppm
  python -m raytpu_torch.cli --scene sphereflake -o balls.ppm
                                           # Haines' SPD "balls", level 4, its view
  python -m raytpu_torch.cli --scene random --num-spheres 256 --seed 3 \
      --width 1920 --height 1080 --max-depth 6 --backend wavefront \
      --strict-drops -o config5.ppm           # BASELINE config 5
  python -m raytpu_torch.cli --backend wavefront --streams 2 -o out.ppm
                                           # chunks on 2 CUDA streams
  python -m raytpu_torch.cli --compare a.ppm b.ppm
  python -m raytpu_torch.cli --list-devices
  python -m torch.distributed.run --nproc-per-node 2 -m raytpu_torch.cli \
      --sharded --interleave -o out.ppm    # pixels split over 2 ranks
  python -m raytpu_torch.cli --oracle --width 400 --height 300 -o strict.ppm
                                           # the reference's strict semantics

The scene lives on the first CUDA device (under torchrun, the card its
LOCAL_RANK names; --device N picks cuda:N), or on the CPU with --cpu;
without --cpu and without a CUDA device the CLI exits 2.  --backend auto
then picks the CUDA kernel (or the wavefront past the measured crossover)
or the eager tracer.  --oracle renders the reference's strict semantics
(its quirks bug for bug) through the oracle kernel (raytpu_torch.native),
or under --cpu the tensor oracle (raytpu_torch.oracle); it ignores
--backend, --time, --sharded and the wavefront's options, as raytpu's
does.
--sharded renders over the process group torchrun describes ("nccl" on
cards, "gloo" with --cpu), or over a world of one without torchrun; rank
0 writes the PPM and the --time line.  More than one rank take the
interleaved pixel sets, with or without --interleave.  A wavefront render
that drops live rays warns, or under --strict-drops exits 3.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from raytpu_torch.config import RenderConfig
from raytpu_torch.parallel.mesh import (describe_devices, initialize_distributed,
                                        local_device, make_mesh)

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="raytpu-torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--width", type=int, default=None,
                   help="default 800, or the scene's view (sphereflake: 512)")
    p.add_argument("--height", type=int, default=None,
                   help="default 600, or the scene's view (sphereflake: 512)")
    p.add_argument("--zoom", type=float, default=-4.0)
    p.add_argument("--alias-factor", type=int, default=3)
    p.add_argument("--max-depth", type=int, default=5)
    p.add_argument("--chunk-pixels", type=int, default=8192,
                   help="pixel chunk of the eager tracer (memory bound only)")
    p.add_argument("--scene", choices=["default", "single", "random",
                                       "sphereflake"],
                   default="default",
                   help="sphereflake: Haines' SPD \"balls\" at --level, "
                        "rendered at the SPD's view (--width and --height "
                        "override its size)")
    p.add_argument("--scene-file", default=None,
                   help="load the scene from a JSON file; overrides --scene")
    p.add_argument("--save-scene", default=None,
                   help="write the active scene as JSON and continue")
    p.add_argument("--num-spheres", type=int, default=64,
                   help="sphere count for --scene random")
    p.add_argument("--level", type=int, default=4,
                   help="size factor for --scene sphereflake (4: 7,381 "
                        "spheres, the SPD's default)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bg-opacity", type=float, default=None,
                   help="background-medium opacity (undefined in the "
                        "reference; see raytpu_torch.scene.Medium); default "
                        "the scene's own (0, sphereflake 1)")
    p.add_argument("-o", "--output", default=None, help="output PPM path")
    p.add_argument("--time", action="store_true", dest="timeit",
                   help="print timing and Mrays/s as JSON (CUDA events on "
                        "a card, the host clock under --cpu)")
    p.add_argument("--backend", choices=["auto", "torch", "cuda", "wavefront"],
                   default="auto",
                   help="compute path: the dense CUDA kernel, the wavefront "
                        "tracer or the eager tracer (auto: cuda or the "
                        "wavefront on a CUDA device, torch on the CPU)")
    p.add_argument("--chunk-rays", type=int, default=None,
                   help="wavefront: camera rays per chunk (default: the "
                        "auto ladder's)")
    p.add_argument("--capacity-factor", type=float, default=None,
                   help="wavefront: per-level live-ray capacity as a "
                        "multiple of the chunk.  Default: the auto ladder, "
                        "escalating and re-rendering on any drop; an "
                        "explicit value is one attempt, and the live rays "
                        "past it are dropped, counted and reported")
    p.add_argument("--strict-drops", action="store_true",
                   help="exit 3 if the wavefront drops any live ray, "
                        "instead of warning")
    p.add_argument("--streams", type=int, default=None,
                   help="wavefront: independent chunk pipelines, chunk c on "
                        "CUDA stream c %% streams (default 1)")
    p.add_argument("--oracle", action="store_true",
                   help="render with the strict-semantics oracle (the oracle "
                        "kernel; the tensor oracle under --cpu)")
    p.add_argument("--oracle-cap", type=int, default=5,
                   help="oracle trace-stack capacity (5 = the GPU build "
                        "that produced testPPM.ppm; 6 = the CPU build)")
    p.add_argument("--fresnel-double", action="store_true",
                   help="oracle uses double-precision Fresnel intermediates "
                        "(the reference CPU build, raytracer.h:380-381); "
                        "default float matches the GPU golden")
    p.add_argument("--device", type=int, default=None,
                   help="render on one specific device index, cuda:N (the "
                        "reference's unused --device picker, "
                        "device_picker.h:70-119); under --cpu the CPU is "
                        "device 0; under --sharded each rank keeps its card")
    p.add_argument("--cpu", action="store_true",
                   help="render on the CPU (default: the first CUDA device)")
    p.add_argument("--list-devices", action="store_true")
    p.add_argument("--compare", nargs=2, metavar=("A.ppm", "B.ppm"),
                   default=None,
                   help="compare two PPM images and print diff stats as "
                        "JSON; all other options are ignored")
    p.add_argument("--sharded", action="store_true",
                   help="split the pixels over the ranks of the process "
                        "group torchrun set up (a world of one without it)")
    p.add_argument("--interleave", action="store_true", default=None,
                   help="with --sharded: give each rank the strided pixel set "
                        "{rank + j*ranks}, which more than one rank takes "
                        "even without it (a world of one renders the whole "
                        "frame either way)")
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
    elif args.scene == "sphereflake":
        built = S.sphereflake_scene(args.level, device=device)
    else:
        built = S.default_scene(device=device)
    # --bg-opacity, where given, applies to every generated scene; files
    # carry their own.
    if args.bg_opacity is None:
        return built
    opacity = torch.tensor(args.bg_opacity, dtype=torch.float32, device=device)
    return dataclasses.replace(built, bg=dataclasses.replace(built.bg,
                                                             opacity=opacity))


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    if args.compare:
        stats = compare_ppms(*args.compare)
        print(json.dumps(stats))
        return 2 if "error" in stats else 0

    if args.list_devices:
        print(describe_devices())
        return 0

    if not args.cpu and not torch.cuda.is_available():
        print("error: no CUDA device found; pass --cpu to render on the CPU",
              file=sys.stderr)
        return 2
    if args.device is not None:
        n_devices = 1 if args.cpu else torch.cuda.device_count()
        if not 0 <= args.device < n_devices:
            print(f"error: device {args.device} not in [0, {n_devices})",
                  file=sys.stderr)
            return 2
    if args.cpu:
        device = torch.device("cpu")
    elif args.device is not None and not args.sharded:
        device = torch.device("cuda", args.device)
    else:
        device = local_device()
    joined = (args.sharded and not args.oracle and "WORLD_SIZE" in os.environ
              and not dist.is_initialized())
    if joined:
        initialize_distributed("env://", backend="gloo" if args.cpu else "nccl")
    try:
        return _render(args, device)
    finally:
        if joined:
            dist.destroy_process_group()


def _oracle_image(args, scene, cfg):
    """The strict-semantics render: the oracle kernel on a card, the tensor
    oracle on the CPU."""
    if scene.device.type == "cuda":
        from raytpu_torch.native import render_native
        return render_native(scene, cfg, cap=args.oracle_cap,
                             fresnel_double=args.fresnel_double)
    from raytpu_torch.oracle import render_oracle
    return render_oracle(scene, cfg, cap=args.oracle_cap,
                         fresnel_double=args.fresnel_double)


def render_config(args) -> RenderConfig:
    """The flags' RenderConfig: the image plane, and the size not given,
    are the sphereflake's SPD view for --scene sphereflake (without
    --scene-file), else 800x600 on a 16x12 plane."""
    from raytpu_torch.scene import SPHEREFLAKE_VIEW

    view = (SPHEREFLAKE_VIEW if args.scene == "sphereflake" and not args.scene_file
            else RenderConfig())
    return RenderConfig(width=view.width if args.width is None else args.width,
                        height=view.height if args.height is None else args.height,
                        image_world_width=view.image_world_width,
                        image_world_height=view.image_world_height,
                        zoom=args.zoom, alias_factor=args.alias_factor,
                        max_depth=args.max_depth, chunk_pixels=args.chunk_pixels)


def _render(args, device) -> int:
    cfg = render_config(args)
    scene = make_scene(args, device)
    mesh = make_mesh(device) if args.sharded and not args.oracle else None
    lead = mesh is None or mesh.rank == 0  # the one rank that writes files
    if args.save_scene and lead:
        from raytpu_torch.scene_io import save_scene
        save_scene(scene, args.save_scene)
        print(f"wrote {args.save_scene}")

    from raytpu_torch.render import (DroppedRaysError, render_sharded,
                                     render_single, render_timed)
    wf_opts = {k: v for k, v in (("chunk_rays", args.chunk_rays),
                                 ("capacity_factor", args.capacity_factor),
                                 ("streams", args.streams))
               if v is not None}
    on_drop = "raise" if args.strict_drops else "warn"
    try:
        if args.oracle:  # first, as in raytpu.cli: the other flags are ignored
            img = _oracle_image(args, scene, cfg)
        elif args.timeit:
            img, stats = render_timed(scene, cfg, mesh, backend=args.backend,
                                      wf_opts=wf_opts, on_drop=on_drop,
                                      interleave=args.interleave)
            if lead:
                print(json.dumps({k: v for k, v in stats.items() if k != "times"}))
        elif mesh is not None:
            img = render_sharded(scene, cfg, mesh, backend=args.backend,
                                 wf_opts=wf_opts, on_drop=on_drop,
                                 interleave=args.interleave)
        else:
            img = render_single(scene, cfg, backend=args.backend,
                                wf_opts=wf_opts, on_drop=on_drop)
    except DroppedRaysError as e:
        print(f"error: {e}", file=sys.stderr)
        return 3

    if args.output and lead:
        from raytpu_torch.image import write_ppm
        write_ppm(img.cpu().numpy(), args.output)
        print(f"wrote {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
