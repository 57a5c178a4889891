"""The benchmark's inputs, made from a configuration file, a traffic file
and the seed: the scene's 11 leaves and the fit's target image.  The
program and the reference get the same tensors.

A configuration's "scene" is either "explicit" (spheres, lights and the
background written out, materials as main.cpp's makeMaterial arguments)
or "random" (raytpu's random_scene recipe: numpy's default_rng drawn in
its order, so that scene seed s is random_scene(256, seed=s) to the bit;
the scene's own "seed" where the configuration fixes one, else the run's).  A traffic file's "jitter" adds seeded normal noise of
the stated standard deviation to leaves; its "target" is the fit's linear
image.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.tracer import LEAF_NAMES


def _material(gloss_factor, matte_col, gloss_col, opacity, ior):
    """raytracer.h:62-71's energy-conserving split, in float32."""
    g = np.float32(gloss_factor)
    return (((np.float32(1.0) - g) * np.asarray(matte_col, np.float32)),
            g * np.asarray(gloss_col, np.float32), np.float32(opacity),
            np.float32(ior))


def _random_specs(spec: dict, seed: int):
    rng = np.random.default_rng(seed)
    spread = spec["spread"]
    spheres = []
    for _ in range(spec["spheres"]):
        pos = rng.uniform(-spread, spread, 3).astype(np.float32)
        pos[2] = -abs(pos[2]) - 6.0
        mat = _material(rng.uniform(0.0, 0.95), rng.uniform(0.05, 1.0, 3),
                        rng.uniform(0.05, 1.0, 3), rng.uniform(0.2, 1.0),
                        rng.uniform(1.1, 2.0))
        spheres.append((pos, np.float32(rng.uniform(0.5, 3.0)), mat))
    lights = [(rng.uniform(-60.0, 60.0, 3).astype(np.float32),
               np.asarray(rng.uniform(0.2, 0.6, 3), np.float32))
              for _ in range(spec["lights"])]
    return spheres, lights, ((0.0, 0.0, 0.0), 1.0, 0.0)


def _explicit_specs(spec: dict):
    spheres = [(np.asarray(s["pos"], np.float32), np.float32(s["radius"]),
                _material(*s["material"])) for s in spec["spheres"]]
    lights = [(np.asarray(l["pos"], np.float32),
               np.asarray(l["col"], np.float32)) for l in spec["lights"]]
    bg = spec["bg"]
    return spheres, lights, (bg["matte"], bg["ior"], bg["opacity"])


def scene_leaves(config: dict, seed: int, device) -> dict:
    """The configuration's scene as {leaf name: float32 tensor on device}."""
    spec = config["scene"]
    spheres, lights, bg = (_random_specs(spec, spec.get("seed", seed))
                           if spec["kind"] == "random" else _explicit_specs(spec))
    arrays = [np.stack([s[0] for s in spheres]),
              np.stack([s[1] for s in spheres]),
              *(np.stack([s[2][i] for s in spheres]) for i in range(4)),
              np.stack([l[0] for l in lights]), np.stack([l[1] for l in lights]),
              np.asarray(bg[0], np.float32), np.float32(bg[1]), np.float32(bg[2])]
    return {k: torch.tensor(np.asarray(a, np.float32), device=device)
            for k, a in zip(LEAF_NAMES, arrays)}


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on `device` for the seed's `stream`-th kind of draw."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


def jittered(leaves: dict, traffic: dict, seed: int) -> dict:
    """The leaves with the traffic's "jitter" {leaf: standard deviation}
    of seeded normal noise added."""
    out = dict(leaves)
    jitter = traffic.get("jitter", {})
    if jitter:
        g = generator(seed, next(iter(leaves.values())).device, 1)
        for name in LEAF_NAMES:  # a fixed order of draws
            if name in jitter:
                t = leaves[name]
                out[name] = t + jitter[name] * torch.randn(
                    t.shape, generator=g, device=t.device, dtype=t.dtype)
    return out


def target(render: dict, traffic: dict, seed: int, device) -> torch.Tensor:
    """The fit's (P, 3) linear target: "uniform" is seeded uniform noise
    in [0, scale)."""
    spec = traffic["target"]
    if spec["kind"] != "uniform":
        raise ValueError(f"unknown target kind {spec['kind']!r}")
    p = render["width"] * render["height"]
    g = generator(seed, device, 2)
    return spec["scale"] * torch.rand((p, 3), generator=g, device=device)
