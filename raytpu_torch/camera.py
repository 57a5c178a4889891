"""Posed cameras: a view of a world-space scene from an eye with a
rotation, for fits from several calibrated views of one scene.

Every tracer's own camera sits at the origin and looks down -z, up +y
(trace.camera_rays).  A View places that camera in the world: its
rotation's rows are the camera's right, up and back in world coordinates
(as scene.spd_view builds them), so a world point p lies at R (p - eye)
in the camera's frame, and a camera ray of direction d leaves the eye
along R^T d.  The identity view is the tracers' own camera, bit for bit.

Two ways to render a posed frame:

  * posed rays (posed_rays): origin = eye, direction = R^T d, for the
    tracers that build their camera rays on the host or in torch (the
    eager tracer, the wavefront's camera state);
  * a posed scene (scene_in_view): every sphere and light moved into the
    camera's frame by differentiable torch ops, for the kernels that make
    their camera rays inside the kernel (K1, K2), which then render the
    camera's own frame.  Within rounding they give the same frame.

R^T d is summed per component in a fixed order with no matmul (so no
TF32 and no reassociation), so that a reference can round it alike.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from raytpu_torch.scene import _apply, _rotation, _unit, look_at


def _turn(axis, angle: float):
    """The right-handed rotation by `angle` radians about the unit `axis`,
    float64 (3, 3); cos and sin by the math module."""
    return _rotation(axis, math.cos(angle), math.sin(angle))


@dataclasses.dataclass(frozen=True, eq=False)
class View:
    """A posed camera: `rotation` (3, 3) float32, rows right, up and back
    in world coordinates, and `eye` (3,) float32, the camera's position.
    Any array-like of those shapes is taken and rounded to float32."""

    rotation: np.ndarray
    eye: np.ndarray

    def __post_init__(self):
        rot = np.asarray(self.rotation, np.float32).reshape(3, 3)
        eye = np.asarray(self.eye, np.float32).reshape(3)
        object.__setattr__(self, "rotation", rot)
        object.__setattr__(self, "eye", eye)

    @staticmethod
    def identity() -> View:
        """The tracers' own camera: eye at the origin, looking down -z."""
        return View(np.eye(3), np.zeros(3))

    @staticmethod
    def look_at(eye, at, up) -> View:
        """The camera at `eye` looking at `at`, `up` upward: scene.look_at's
        float64 rows (right, up, back), rounded once."""
        return View(*look_at(eye, at, up))

    def scalars(self):
        """(rotation rows, eye) as Python floats holding float32 values,
        which torch multiplies with float32 tensors in float32."""
        return ([[float(v) for v in row] for row in self.rotation],
                [float(v) for v in self.eye])


def turntable(view: View, n: int, axis=(0.0, 0.0, 1.0), pivot=(0.0, 0.0, 0.0)):
    """The n views of a turntable: `view` turned about `axis` through the
    point `pivot` by k x 360/n degrees, k = 0 .. n-1 (view 0 is `view`
    itself).  A camera turned by T has eye pivot + T (eye - pivot) and
    rotation R T^T, worked in float64 from the view's float32 values and
    rounded once."""
    if n < 1:
        raise ValueError(f"a turntable takes n >= 1 views, got {n}")
    axis = _unit(np.asarray(axis, np.float64))
    pivot = np.asarray(pivot, np.float64)
    rot = view.rotation.astype(np.float64)
    eye = view.eye.astype(np.float64)
    out = []
    for k in range(n):
        turn = _turn(axis, 2.0 * math.pi * k / n)
        out.append(View(np.stack([_apply(turn, row) for row in rot]),
                        pivot + _apply(turn, eye - pivot)))
    return out


def posed_directions(view: View, d):
    """R^T d of camera directions d (B, 3) in the camera's frame: the
    world direction, each component summed in a fixed order,
    ((R0j dx + R1j dy) + R2j dz), in float32."""
    rot, _ = view.scalars()
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    return torch.stack([(rot[0][j] * dx + rot[1][j] * dy) + rot[2][j] * dz
                        for j in range(3)], dim=-1)


def posed_rays(view: View, d):
    """(origin (B, 3), direction (B, 3)) of the camera rays whose
    directions in the camera's frame are d: the eye, and R^T d."""
    _, eye = view.scalars()
    origin = torch.stack([torch.full_like(d[:, 0], e) for e in eye], dim=-1)
    return origin, posed_directions(view, d)


def _into_view(view: View, p):
    """R (p - eye) of world points p (M, 3), in float32, summed per
    component in a fixed order; differentiable in p."""
    rot, eye = view.scalars()
    q = [p[:, i] - eye[i] for i in range(3)]
    return torch.stack([(rot[r][0] * q[0] + rot[r][1] * q[1]) + rot[r][2] * q[2]
                        for r in range(3)], dim=-1)


def scene_in_view(scene, view: View):
    """The scene moved into the view's camera frame: every sphere's and
    light's position p becomes R (p - eye), by torch ops that autograd
    differentiates, the other leaves as they are.  Rendered by the
    tracers' own camera it is the posed frame, within rounding."""
    return dataclasses.replace(
        scene,
        spheres=dataclasses.replace(scene.spheres,
                                    pos=_into_view(view, scene.spheres.pos)),
        lights=dataclasses.replace(scene.lights,
                                   pos=_into_view(view, scene.lights.pos)))
