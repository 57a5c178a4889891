"""Gradient fit against a golden PPM (the counterpart of
examples/fit_golden_scene.py): perturb the default scene's sphere
positions, then recover them by Adam against the 8-bit, max-normalized
image the golden holds.

The target went through the reference's tone map and byte truncation, so
the loss profiles the unknown global exposure out in closed form
(raytpu_torch.grad.exposure_image_loss) and fits the image's shape.  Each
step renders a strided pixel subset, gid = arange(0, P, stride), which
trains through the eager tracer (what "auto" takes for a gid).  The frame's
width and height are the golden's; its depth is --depth.

Run:  python -m raytpu_torch.examples.fit_golden_scene \\
          --golden tests/goldens/default_160x120_d4.ppm --depth 4 --cpu

The perturbation draws from numpy.random.default_rng(seed), not
jax.random, so the port's start scene differs from the JAX example's.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np
import torch


def golden_target(path: str, device=None):
    """Decode a golden PPM -> (P, 3) float target in [0, 1] on `device`
    (None: this process's card, device.local_device), and its
    (height, width)."""
    from raytpu_torch.image import read_ppm
    from raytpu_torch.device import resolve_device

    device = resolve_device(device)
    g = read_ppm(path).astype(np.float32) / 255.0
    return torch.tensor(g.reshape(-1, 3), device=device), g.shape[:2]


def fit_golden(scene, cfg, target_flat, gid, steps: int = 150, lr: float = 5e-2,
               trainable=None, callback=None):
    """Adam-fit `scene` against the tone-mapped target on the pixel subset
    `gid`, the exposure profiled out at every step -> (scene, losses)."""
    from raytpu_torch.grad import _value_and_grad, exposure_image_loss
    from raytpu_torch.scene import scene_from_leaves, scene_leaves

    params = [t.detach().clone() for t in scene_leaves(scene)]
    opt = torch.optim.Adam(params, lr=lr)
    mask = ([True] * len(params) if trainable is None
            else [bool(m) for m in scene_leaves(trainable)])
    losses = []
    for step in range(steps):
        loss, grads = _value_and_grad(
            lambda s: exposure_image_loss(s, cfg, target_flat, gid),
            scene_from_leaves(params))
        for p, g, m in zip(params, scene_leaves(grads), mask):
            p.grad = g if m else torch.zeros_like(g)
        opt.step()
        losses.append(float(loss))
        if callback is not None:
            callback(step, losses[-1], scene_from_leaves(params))
    return scene_from_leaves([p.detach().clone() for p in params]), losses


def perturbed_positions(truth, sigma: float, seed: int):
    """The truth scene with its sphere positions moved by seeded Gaussian
    noise of standard deviation `sigma`."""
    noise = np.random.default_rng(seed).standard_normal(
        tuple(truth.spheres.pos.shape)).astype(np.float32)
    pos = truth.spheres.pos + sigma * torch.tensor(noise, device=truth.device)
    return dataclasses.replace(truth, spheres=dataclasses.replace(truth.spheres,
                                                                  pos=pos))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="raytpu_torch.examples.fit_golden_scene",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--golden", required=True,
                    help="the golden P6 PPM to fit against (the reference "
                         "writes testPPM.ppm at 800x600 depth 5)")
    ap.add_argument("--depth", type=int, default=5,
                    help="the depth that rendered the golden")
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--lr", type=float, default=5e-2)
    ap.add_argument("--stride", type=int, default=117,
                    help="pixel-subset stride (117 -> ~4.1K pixels a step "
                         "at 800x600)")
    ap.add_argument("--perturb", type=float, default=0.3,
                    help="standard deviation of the position perturbation")
    ap.add_argument("--seed", type=int, default=2)
    ap.add_argument("--alias", type=int, default=1,
                    help="the model's AA factor (the golden used 3; 1 is ~9x "
                         "cheaper and the mismatch is far below the "
                         "perturbation's signal)")
    ap.add_argument("--cpu", action="store_true",
                    help="fit on the CPU (default: the first CUDA device)")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("error: no CUDA device found; pass --cpu to fit on the CPU",
              file=sys.stderr)
        raise SystemExit(2)
    device = torch.device("cpu" if args.cpu else "cuda:0")

    from raytpu_torch.config import RenderConfig
    from raytpu_torch.grad import exposure_image_loss
    from raytpu_torch.scene import LEAF_NAMES, default_scene, scene_from_leaves

    target, (height, width) = golden_target(args.golden, device)
    cfg = RenderConfig(width=width, height=height, max_depth=args.depth,
                       alias_factor=args.alias)
    gid = torch.arange(0, cfg.num_pixels, args.stride, device=device)
    truth = default_scene(device=device)  # the scene that rendered the golden
    scene = perturbed_positions(truth, args.perturb, args.seed)
    err0 = float((scene.spheres.pos - truth.spheres.pos).abs().max())
    trainable = scene_from_leaves([n == "spheres.pos" for n in LEAF_NAMES])

    with torch.no_grad():
        floor = float(exposure_image_loss(truth, cfg, target, gid))
    print(f"model-mismatch floor (truth scene vs golden): {floor:.3e}")

    def cb(step, loss, s):
        if step % 10 == 0:
            print(f"step {step:4d}: loss {loss:.3e}")

    fitted, losses = fit_golden(scene, cfg, target, gid, steps=args.steps,
                                lr=args.lr, trainable=trainable, callback=cb)
    err1 = float((fitted.spheres.pos - truth.spheres.pos).abs().max())
    print(f"loss: {losses[0]:.3e} -> {losses[-1]:.3e} "
          f"({losses[0] / max(losses[-1], 1e-30):.1f}x reduction; "
          f"floor {floor:.3e})")
    print(f"sphere position error vs the golden's scene: {err0:.3f} -> {err1:.3f}")
    return dict(cfg=cfg, gid=gid, scene=scene, fitted=fitted, losses=losses,
                floor=floor)


if __name__ == "__main__":
    main()
