"""Gradient-fit demo (BASELINE config 4): recover perturbed scene parameters
by gradient descent against a rendered target image (the counterpart of
examples/fit_scene.py).

Run on the card:  python -m raytpu_torch.examples.fit_scene --steps 60
Run on the CPU:   python -m raytpu_torch.examples.fit_scene --cpu --steps 60
Config 3's training step (640x480, depth 4, 3x3 AA):
    python -m raytpu_torch.examples.fit_scene --width 640 --height 480 \\
        --depth 4 --alias-factor 3 --mode geometry --steps 3
The same through the differentiable wavefront: add --backend wavefront.
The sharded fit (--mesh) is not ported yet (ROADMAP Queue 1 item 7).

The perturbation draws from numpy.random.default_rng(0), not jax.random:
the port cannot reproduce jax.random's bits, so its perturbed scene differs
from the JAX example's.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="raytpu_torch.examples.fit_scene",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--width", type=int, default=80)
    ap.add_argument("--height", type=int, default=60)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--alias-factor", type=int, default=1)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=2e-2)
    ap.add_argument("--mode", choices=["colours", "geometry"], default="colours",
                    help="colours: perturb/fit matte + light colours (smooth "
                         "gradients, converges to ~0); geometry: also "
                         "positions/radii (silhouette sub-gradients, partial)")
    ap.add_argument("--cpu", action="store_true",
                    help="fit on the CPU (default: the first CUDA device)")
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="shard the fit over N devices (not ported yet)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "torch", "cuda", "wavefront"],
                    help="gradient backend: cuda, the forward/backward kernel "
                         "pair; wavefront, the differentiable wavefront (the "
                         "large-scene path: per-level kernels and their "
                         "backwards, live-ray compaction and its transpose, "
                         "the capacity ladder on drops); torch, autograd "
                         "through the eager tracer; auto, as "
                         "raytpu_torch.grad.resolve_train_backend")
    ap.add_argument("--checkpoint", default=None,
                    help="path to save/restore the fit's scene every 10 steps")
    return ap


def perturb(truth, geometry: bool, seed: int = 0):
    """The truth scene with its matte and light colours (and, for
    geometry, its positions and radii) moved by seeded Gaussian noise."""
    rng = np.random.default_rng(seed)
    device = truth.device

    def noise(t):
        return torch.tensor(rng.standard_normal(tuple(t.shape)).astype(np.float32),
                            device=device)

    sph = truth.spheres
    sph = dataclasses.replace(
        sph, matte=torch.clamp(sph.matte + 0.15 * noise(sph.matte), 0.0, 1.0))
    lights = dataclasses.replace(
        truth.lights,
        col=torch.clamp(truth.lights.col + 0.2 * noise(truth.lights.col), 0.05, 2.0))
    if geometry:
        sph = dataclasses.replace(
            sph, pos=sph.pos + 0.3 * noise(sph.pos),
            radius=sph.radius * (1 + 0.1 * noise(sph.radius)))
    return dataclasses.replace(truth, spheres=sph, lights=lights)


def main(argv=None) -> dict:
    """Run the fit; returns the config, the truth, the perturbed start, the
    target, the fitted scene, the start loss and every step's loss."""
    args = build_parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError(
            "--mesh: the sharded fit is not ported yet (ROADMAP Queue 1 item 7)")
    if not args.cpu and not torch.cuda.is_available():
        print("error: no CUDA device found; pass --cpu to fit on the CPU",
              file=sys.stderr)
        raise SystemExit(2)
    device = torch.device("cpu" if args.cpu else "cuda:0")

    from raytpu_torch.config import RenderConfig
    from raytpu_torch.grad import fit_scene, image_loss
    from raytpu_torch.render import render_single
    from raytpu_torch.scene import LEAF_NAMES, default_scene, scene_from_leaves
    from raytpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

    cfg = RenderConfig(width=args.width, height=args.height,
                       max_depth=args.depth, alias_factor=args.alias_factor)
    truth = default_scene(device=device)
    target = render_single(truth, cfg, backend=args.backend).reshape(-1, 3)
    scene = perturb(truth, args.mode == "geometry")

    if args.checkpoint and os.path.exists(args.checkpoint):
        scene = load_checkpoint(args.checkpoint, scene)
        print(f"restored {args.checkpoint}")

    # Only fit what was perturbed.
    fitted_leaves = {"spheres.matte", "lights.col"}
    if args.mode == "geometry":
        fitted_leaves |= {"spheres.pos", "spheres.radius"}
    trainable = scene_from_leaves([n in fitted_leaves for n in LEAF_NAMES])

    with torch.no_grad():
        start = float(image_loss(scene, cfg, target, backend=args.backend))

    def cb(step, loss, s):
        if step % 10 == 0:
            print(f"step {step:4d}: loss {loss:.3e}")
            if args.checkpoint:
                save_checkpoint(args.checkpoint, s)

    # The linear image is ~1e-4 scale (inverse-square lights), so MSE
    # gradients are ~1e-12, far below Adam's default eps=1e-8; a
    # scale-appropriate eps restores Adam's scale invariance.
    fitted, losses = fit_scene(
        scene, cfg, target, steps=args.steps, learning_rate=args.lr,
        callback=cb, trainable=trainable, backend=args.backend,
        optimizer=lambda p: torch.optim.Adam(p, lr=args.lr, eps=1e-16))
    print(f"loss: {start:.3e} -> {losses[-1]:.3e} "
          f"({start / max(losses[-1], 1e-30):.1f}x reduction)")
    err = (fitted.spheres.pos - truth.spheres.pos).abs().max()
    print(f"sphere position error: max {float(err):.4f}")
    return dict(cfg=cfg, truth=truth, scene=scene, target=target,
                fitted=fitted, start_loss=start, losses=losses)


if __name__ == "__main__":
    main()
