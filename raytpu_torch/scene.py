"""Scene data model: struct-of-arrays dataclasses of float32 tensors.

The counterpart of raytpu.scene.  Each field is one contiguous (N, ...)
tensor; materials are folded into `Spheres` (one material per sphere, as in
the reference).  The builders draw every number with numpy exactly as
raytpu.scene does, so both packages build bit-identical scenes.  Every
builder puts its scene on this process's card unless given a device, and
raises without one (device.local_device): a CPU scene is asked for
with device="cpu".
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from raytpu_torch.device import resolve_device


def _to(obj, device):
    return dataclasses.replace(obj, **{
        f.name: getattr(obj, f.name).to(device) for f in dataclasses.fields(obj)})


@dataclasses.dataclass
class Spheres:
    """SoA sphere list with per-sphere material (sphere.h:9-14,
    material.h:8-14)."""

    pos: torch.Tensor      # (N, 3)
    radius: torch.Tensor   # (N,)
    matte: torch.Tensor    # (N, 3) — already scaled by (1 - gloss_factor)
    gloss: torch.Tensor    # (N, 3) — already scaled by gloss_factor
    opacity: torch.Tensor  # (N,)
    ior: torch.Tensor      # (N,) refractive index

    @property
    def count(self) -> int:
        return self.pos.shape[0]

    def to(self, device) -> Spheres:
        return _to(self, device)


@dataclasses.dataclass
class Lights:
    """SoA point-light list (raytracer.h:20-25)."""

    pos: torch.Tensor  # (L, 3)
    col: torch.Tensor  # (L, 3)

    @property
    def count(self) -> int:
        return self.pos.shape[0]

    def to(self, device) -> Lights:
        return _to(self, device)


@dataclasses.dataclass
class Medium:
    """The material a ray travels through.  matte paints misses, ior feeds
    Snell's law, and opacity scales the glossy reflection of the hit object
    (a reference quirk).  The background's opacity is undefined in the
    reference; see raytpu.scene.Medium."""

    matte: torch.Tensor    # (3,)
    ior: torch.Tensor      # ()
    opacity: torch.Tensor  # ()

    def to(self, device) -> Medium:
        return _to(self, device)


@dataclasses.dataclass
class Scene:
    spheres: Spheres
    lights: Lights
    bg: Medium  # background medium for rays outside every sphere

    @property
    def device(self) -> torch.device:
        return self.spheres.pos.device

    def to(self, device) -> Scene:
        return Scene(self.spheres.to(device), self.lights.to(device),
                     self.bg.to(device))


def make_material(gloss_factor, matte_col, gloss_col, opacity, ior):
    """Energy-conserving matte/gloss split (raytracer.h:62-71):
    matte = (1-g)*matte_col, gloss = g*gloss_col, in float32 numpy."""
    g = np.float32(gloss_factor)
    return dict(
        matte=(np.float32(1.0) - g) * np.asarray(matte_col, np.float32),
        gloss=g * np.asarray(gloss_col, np.float32),
        opacity=np.float32(opacity),
        ior=np.float32(ior),
    )


def build_scene(sphere_specs, light_specs, bg_matte=(0.0, 0.0, 0.0),
                bg_ior=1.0, bg_opacity=0.0, device=None) -> Scene:
    """Assemble a Scene on `device` from per-object specs.  `device` None
    is this process's card (device.local_device), which raises
    without one: a CPU scene is asked for with device="cpu".

    sphere_specs: iterable of (pos(3,), radius, material-dict from make_material)
    light_specs: iterable of (pos(3,), col(3,))
    """
    poss, radii, mattes, glosses, opacities, iors = [], [], [], [], [], []
    for pos, radius, mat in sphere_specs:
        poss.append(np.asarray(pos, np.float32))
        radii.append(np.float32(radius))
        mattes.append(mat["matte"])
        glosses.append(mat["gloss"])
        opacities.append(mat["opacity"])
        iors.append(mat["ior"])
    lpos = [np.asarray(p, np.float32) for p, _ in light_specs]
    lcol = [np.asarray(c, np.float32) for _, c in light_specs]
    device = resolve_device(device)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return Scene(
        spheres=Spheres(pos=f32(np.stack(poss)), radius=f32(np.stack(radii)),
                        matte=f32(np.stack(mattes)),
                        gloss=f32(np.stack(glosses)),
                        opacity=f32(np.stack(opacities)),
                        ior=f32(np.stack(iors))),
        lights=Lights(pos=f32(np.stack(lpos)), col=f32(np.stack(lcol))),
        bg=Medium(matte=f32(bg_matte), ior=f32(bg_ior), opacity=f32(bg_opacity)),
    )


def default_scene(bg_opacity: float = 0.0, device=None) -> Scene:
    """The reference's hard-coded golden scene (main.cpp:104-168): three
    spheres, two half-white lights, a matte-black background of IOR 1."""
    green = (0.4, 0.5, 0.7)   # "greenCol", main.cpp:119-120
    red = (0.8, 1.0, 0.7)     # "redCol", main.cpp:117-118
    col1 = (0.01, 0.8, 0.01)  # main.cpp:122-123
    lower_white = (0.5, 0.5, 0.5)
    mat1 = make_material(0.2, green, red, opacity=0.8, ior=1.55)
    mat2 = make_material(0.95, green, red, opacity=0.3, ior=1.55)
    mat3 = make_material(0.0, col1, col1, opacity=0.6, ior=1.55)
    return build_scene(
        sphere_specs=[
            ((-9.0, 0.0, -13.0), 5.0, mat1),
            ((-4.0, 1.5, -5.0), 2.0, mat2),
            ((1.0, -1.0, -7.0), 3.0, mat3),
        ],
        light_specs=[
            ((-45.0, 10.0, 85.0), lower_white),
            ((20.0, 60.0, -5.0), lower_white),
        ],
        bg_opacity=bg_opacity,
        device=device,
    )


def single_sphere_scene(device=None) -> Scene:
    """BASELINE config 1: one opaque matte sphere, one light, depth 0."""
    mat = make_material(0.0, (0.9, 0.4, 0.2), (0.0, 0.0, 0.0), opacity=1.0, ior=1.0)
    return build_scene(
        sphere_specs=[((0.0, 0.0, -8.0), 3.0, mat)],
        light_specs=[((10.0, 10.0, 10.0), (1.0, 1.0, 1.0))],
        device=device,
    )


def random_scene(num_spheres: int, num_lights: int = 4, seed: int = 0,
                 spread: float = 40.0, device=None) -> Scene:
    """Procedural scene for the large benchmark configs (BASELINE config 5:
    256 spheres).  Draws from numpy's default_rng(seed) in the same order as
    raytpu.scene.random_scene, so the two scenes are bit-identical."""
    rng = np.random.default_rng(seed)
    specs = []
    for _ in range(num_spheres):
        pos = rng.uniform(-spread, spread, 3).astype(np.float32)
        pos[2] = -abs(pos[2]) - 6.0  # keep in front of the camera
        mat = make_material(
            gloss_factor=rng.uniform(0.0, 0.95),
            matte_col=rng.uniform(0.05, 1.0, 3),
            gloss_col=rng.uniform(0.05, 1.0, 3),
            opacity=rng.uniform(0.2, 1.0),
            ior=rng.uniform(1.1, 2.0),
        )
        specs.append((pos, rng.uniform(0.5, 3.0), mat))
    lights = [
        (rng.uniform(-60.0, 60.0, 3).astype(np.float32), rng.uniform(0.2, 0.6, 3))
        for _ in range(num_lights)
    ]
    return build_scene(specs, lights, device=device)


_LEAVES = {"spheres": ("pos", "radius", "matte", "gloss", "opacity", "ior"),
           "lights": ("pos", "col"),
           "bg": ("matte", "ior", "opacity")}
# "spheres.pos", ..., "bg.opacity", in scene_leaves order.
LEAF_NAMES = tuple(f"{group}.{name}" for group, names in _LEAVES.items()
                   for name in names)


def scene_leaves(scene: Scene) -> tuple:
    """The scene's 11 tensors in the order of JAX's tree_leaves of a
    raytpu Scene: spheres pos, radius, matte, gloss, opacity, ior; lights
    pos, col; bg matte, ior, opacity."""
    return tuple(getattr(getattr(scene, group), name)
                 for group, names in _LEAVES.items() for name in names)


def scene_from_leaves(leaves) -> Scene:
    """The inverse of scene_leaves (the tensors are used as they are)."""
    it = iter(leaves)
    classes = {"spheres": Spheres, "lights": Lights, "bg": Medium}
    return Scene(**{group: classes[group](**{n: next(it) for n in names})
                    for group, names in _LEAVES.items()})


def scene_to_numpy(scene: Scene) -> dict:
    """The scene's leaves as float32 numpy arrays keyed "spheres.pos", ...,
    "bg.opacity" — the inverse of scene_from_numpy."""
    return {key: t.detach().cpu().numpy()
            for key, t in zip(LEAF_NAMES, scene_leaves(scene))}


def scene_from_numpy(d: dict, device=None) -> Scene:
    """Build the port's Scene on `device` (None: build_scene's default)
    from a dict of numpy leaves keyed "spheres.pos", ..., "bg.opacity" (for
    example raytpu's Scene pytree leaves converted with np.asarray) — the
    port's scene conversion."""
    device = resolve_device(device)
    return scene_from_leaves(
        torch.tensor(np.asarray(d[key], np.float32), device=device)
        for key in LEAF_NAMES)
