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

from raytpu_torch.config import RenderConfig
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


# Haines' Standard Procedural Databases (E. Haines, "A Proposal for
# Standard Graphics Environments", IEEE CG&A 7(11), 1987), "balls", the
# sphereflake: the view, lights, background and sphere surface of the SPD
# package's balls.c.
SPD_FROM = (2.1, 1.3, 1.7)
SPD_AT = (0.0, 0.0, 0.0)
SPD_UP = (0.0, 0.0, 1.0)
SPD_LIGHTS = ((4.0, 3.0, 2.0), (1.0, -4.0, 4.0), (-3.0, 1.0, 5.0))
SPD_SKY = (0.078, 0.361, 0.753)  # UNC sky blue
# The view as a RenderConfig: 512x512, a 45 degree field of view at aspect
# 1, so an image plane 2 * 4 * tan(22.5 degrees) = 8 (sqrt(2) - 1) wide at
# the camera's |zoom| of 4.
SPD_WORLD = 8.0 * (np.sqrt(2.0) - 1.0)
SPHEREFLAKE_VIEW = RenderConfig(width=512, height=512, zoom=-4.0, alias_factor=3,
                                max_depth=5, image_world_width=float(SPD_WORLD),
                                image_world_height=float(SPD_WORLD))


def _rotation(axis, cos, sin):
    """The rotation by the angle of (cos, sin) about the unit `axis`, right
    handed (Rodrigues), as a float64 (3, 3) matrix."""
    x, y, z = axis
    c1 = 1.0 - cos
    return np.array([[cos + x * x * c1, x * y * c1 - z * sin, x * z * c1 + y * sin],
                     [y * x * c1 + z * sin, cos + y * y * c1, y * z * c1 - x * sin],
                     [z * x * c1 - y * sin, z * y * c1 + x * sin, cos + z * z * c1]])


def _apply(m, v):
    """m @ v with the products summed in a fixed order (no BLAS, no fused
    multiply-add), so that the flake is the same float64 on every machine."""
    return np.array([(m[r, 0] * v[0] + m[r, 1] * v[1]) + m[r, 2] * v[2]
                     for r in range(3)])


def _unit(v):
    """v / |v|, the squares summed in a fixed order as _apply sums."""
    return v / np.sqrt((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2])


def _flake_directions():
    """balls.c's create_objset: the nine child directions of a sphere whose
    axis is +z.  Its trio (1, 1, 0), (1, 0, -1), (0, 1, -1) over sqrt(2),
    turned about (1, -1, 0) by asin(2 / sqrt(6)), gives one direction
    54.74 degrees above the equator and two on it; the trio turned about z
    by 0, 120 and 240 degrees gives the nine: six on the equator 60 degrees
    apart and three above it 120 degrees apart, nine of a cuboctahedron's
    twelve vertex directions (the three toward the parent left out)."""
    d = 1.0 / np.sqrt(2.0)
    trio = [np.array(v) for v in ((d, d, 0.0), (d, 0.0, -d), (0.0, d, -d))]
    tilt = _rotation((d, -d, 0.0), 1.0 / np.sqrt(3.0), np.sqrt(2.0 / 3.0))
    trio = [_apply(tilt, v) for v in trio]
    half = np.sqrt(3.0) / 2.0
    turns = [_rotation((0.0, 0.0, 1.0), c, s)
             for c, s in ((1.0, 0.0), (-0.5, half), (-0.5, -half))]
    return [_apply(turn, v) for turn in turns for v in trio]


def _frame(direction):
    """balls.c's child frame: the least rotation taking +z to the unit
    `direction` (about z x direction), the identity along +z and a half
    turn about y along -z (where z x direction vanishes)."""
    s = np.hypot(direction[0], direction[1])
    if s < 1e-9:  # along the axis: exactly so but for rounding
        return np.eye(3) if direction[2] > 0 else np.diag([-1.0, 1.0, -1.0])
    return _rotation((-direction[1] / s, direction[0] / s, 0.0), direction[2], s)


def sphereflake_spheres(level: int = 4):
    """The sphereflake of balls.c at size factor `level`, in the SPD's own
    frame (z up): (centres (N, 3), radii (N,), parents (N,)), float64 and
    int64, the spheres in balls.c's output order (a sphere, then each
    child's flake in turn), parent -1 for the top sphere.  N = (9^(level
    + 1) - 1) / 8: 7,381 at level 4.  The top sphere has radius 0.5 at the
    origin with its axis +z; a sphere's nine children, a third its radius,
    touch it (their centres r + r/3 away) along _flake_directions turned
    into its frame, each child's axis pointing away from its parent."""
    if level < 0:
        raise ValueError(f"level must be >= 0, got {level}")
    objset = _flake_directions()
    centres, radii, parents = [], [], []

    def grow(centre, radius, axis, parent, depth):
        me = len(centres)
        centres.append(centre)
        radii.append(radius)
        parents.append(parent)
        if depth == 0:
            return
        frame = _frame(axis)
        child = radius / 3.0
        for v in objset:
            d = _apply(frame, v)
            grow(centre + (radius + child) * d, child, d, me, depth - 1)

    grow(np.zeros(3), 0.5, np.array([0.0, 0.0, 1.0]), -1, level)
    return np.array(centres), np.array(radii), np.array(parents, dtype=np.int64)


def look_at(eye, at, up):
    """The camera at `eye` looking at `at`, `up` upward, as a rigid map p
    -> rotation @ (p - eye) into the port's camera frame (eye at the
    origin, looking down -z, up +y): (rotation (3, 3), eye (3,)), float64.
    Its rows are the camera's right (up x back), up (back x right) and
    back ((eye - at) / |eye - at|)."""
    eye, at, up = (np.array(v, np.float64) for v in (eye, at, up))
    back = _unit(eye - at)
    right = _unit(np.cross(up, back))
    return np.stack([right, np.cross(back, right), back]), eye


def spd_view():
    """The SPD view, look_at(SPD_FROM, SPD_AT, SPD_UP)."""
    return look_at(SPD_FROM, SPD_AT, SPD_UP)


def sphereflake_scene(level: int = 4, device=None) -> Scene:
    """Haines' SPD "balls" at size factor `level` (4, the SPD's default: 7,381
    spheres), spheres only (the SPD's ground polygon is left out), moved
    rigidly into the port's camera frame at the SPD view; render it at
    SPHEREFLAKE_VIEW.  Every centre and light is moved in float64 and
    rounded once to float32.

    The SPD's three lights are coloured 1/sqrt(3) each (its README's
    1/sqrt(number of lights)); the background is its sky, matte, ior 1 and
    opacity 1.  The spheres' NFF surface "f 1 0.9 0.7 0.5 0.5" (Kd 0.5, Ks
    0.5, T 0) maps onto the upstream's material as make_material(0.5, (1,
    0.9, 0.7), white, opacity=0.999, ior=1.5): the upstream reflects off a
    sphere's outside with the weight medium opacity x gloss, so the
    background's opacity 1 and gloss factor 0.5 give the Ks 0.5 mirror;
    and a node spawns its children only where the transparency is above 0,
    so 0.001 is the least that lets it reflect (its refraction child
    carries under 1e-3 of the intensity and shades nothing)."""
    centres, radii, _ = sphereflake_spheres(level)
    rot, eye = spd_view()
    pos = [_apply(rot, c - eye) for c in centres]
    lights = [_apply(rot, np.array(p) - eye) for p in SPD_LIGHTS]
    mat = make_material(0.5, (1.0, 0.9, 0.7), (1.0, 1.0, 1.0), opacity=0.999,
                        ior=1.5)
    col = np.full(3, 1.0 / np.sqrt(len(SPD_LIGHTS)))
    return build_scene([(p, r, mat) for p, r in zip(pos, radii)],
                       [(p, col) for p in lights], bg_matte=SPD_SKY,
                       bg_ior=1.0, bg_opacity=1.0, device=device)


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
