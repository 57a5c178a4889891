"""Render an animation: orbit sphere 0 and write one PPM a frame (the
counterpart of examples/animate.py).

The wavefront's many-frame pattern: frame 0 climbs the auto-capacity
ladder and returns the options that rendered it in info['wf_opts']; later
frames pass those back and skip the ladder's dropped attempts.  If the
moving geometry outgrows the pinned capacity, the drop counter fires
(on_drop="warn") and the next frame climbs the ladder again.

Run on the card:  python -m raytpu_torch.examples.animate --frames 24 \\
                      --width 1920 --height 1080 --depth 6 --spheres 256
Run on the CPU:   python -m raytpu_torch.examples.animate --frames 8 --cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys

import torch


def orbit(scene, angle: float, radius: float = 6.0):
    """Sphere 0 moved on a circle in the x/z plane through its start (in
    numpy, rounded as raytpu's example rounds it)."""
    pos = scene.spheres.pos.cpu().numpy()
    new = pos.copy()
    new[0, 0] = pos[0, 0] + radius * (math.cos(angle) - 1.0)
    new[0, 2] = pos[0, 2] + radius * math.sin(angle)
    return dataclasses.replace(scene, spheres=dataclasses.replace(
        scene.spheres, pos=torch.tensor(new, device=scene.device)))


def main(argv=None) -> list:
    """Render the frames; returns (path, image, info) for each."""
    ap = argparse.ArgumentParser(prog="raytpu_torch.examples.animate",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--spheres", type=int, default=0,
                    help="a random scene of N spheres (default: the golden's)")
    ap.add_argument("--backend", default="wavefront",
                    choices=["auto", "torch", "cuda", "wavefront"])
    ap.add_argument("--outdir", default="frames")
    ap.add_argument("--cpu", action="store_true",
                    help="render on the CPU (default: the first CUDA device)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("error: no CUDA device found; pass --cpu to render on the CPU",
              file=sys.stderr)
        raise SystemExit(2)
    device = torch.device("cpu" if args.cpu else "cuda:0")

    from raytpu_torch.config import RenderConfig
    from raytpu_torch.image import write_ppm
    from raytpu_torch.render import render_single
    from raytpu_torch.scene import default_scene, random_scene

    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, alias_factor=1)
    base = (random_scene(args.spheres, device=device) if args.spheres
            else default_scene(device=device))
    os.makedirs(args.outdir, exist_ok=True)

    pinned = None  # frame 0's resolved wavefront options
    frames = []
    for f in range(args.frames):
        scene = orbit(base, 2 * math.pi * f / max(args.frames, 1))
        img, info = render_single(scene, cfg, backend=args.backend,
                                  wf_opts=pinned, return_info=True,
                                  on_drop="warn")
        if info.get("wf_opts") is not None:
            # Outgrew the pinned capacity: climb the ladder again next frame.
            pinned = None if pinned is not None and info["dropped"] > 0 \
                else info["wf_opts"]
        path = os.path.join(args.outdir, f"frame_{f:04d}.ppm")
        write_ppm(img.cpu().numpy(), path)
        print(f"{path}: dropped={info['dropped']}"
              + (f" wf_opts={info.get('wf_opts')}" if f == 0 else ""))
        frames.append((path, img, info))
    return frames


if __name__ == "__main__":
    main()
