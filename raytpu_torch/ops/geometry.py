"""Ray-sphere geometry: intersection, closest hit, containment.

Reference semantics (masked and batched, as raytpu.ops.geometry):
  * raySphere        raytracer.h:81-141   (quadratic hit test, eps=1e-5,
                                           smallestT init 10000)
  * calcIntersection raytracer.h:145-194  (closest hit over spheres,
                                           kMaxRenderDist=1000, strict '<'
                                           so the lowest index wins ties)
  * primaryContainer raytracer.h:245-270  (first sphere containing a point,
                                           radius inflated by 1e-6, else -1)

Every op is batched over a leading ray shape (..., 3) against all N spheres.
"""

from __future__ import annotations

import dataclasses

import torch

from raytpu_torch.ops.algebra import safe_sqrt

K_RAY_EPS = 1e-5         # raytracer.h:86
K_SMALLEST_T_INIT = 1e4  # raytracer.h:119
K_MAX_RENDER_DIST = 1e3  # raytracer.h:156
K_CONTAIN_EPS = 1e-6     # raytracer.h:252


def dot3(a, b):
    """Sum over the last axis of a*b, written out as (x + y) + z so that it
    rounds the same on every device and as the CUDA kernel does."""
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def normalize(v):
    """vnorm (vec.h:41): v / |v|, with the null vector's denominator guarded
    so values and gradients stay finite on lanes the caller masks.

    1/sqrt rather than torch.rsqrt: both round the same on the CPU, but
    CUDA's rsqrt is approximate (2 ulp), and the plain version on the card
    must round as the CUDA kernel does."""
    n2 = dot3(v, v)
    n2 = torch.where(n2 == 0, torch.ones_like(n2), n2)
    return v * (1.0 / torch.sqrt(n2))[..., None]


def ray_sphere_t(origin, direction, centers, radii):
    """Batched raySphere (raytracer.h:81-141).

    Args:
      origin, direction: (..., 3) ray bundles (direction need not be unit —
        refracted rays in the reference are unnormalized).
      centers: (N, 3); radii: (N,).

    Returns:
      t:     (..., N) smallest root > 1e-5 per (ray, sphere), else 10000.
      found: (..., N) bool — a real root in (1e-5, 10000).
    """
    disp = origin[..., None, :] - centers                     # (..., N, 3)
    a = dot3(direction, direction)[..., None]                 # (..., 1)
    b = 2.0 * dot3(direction[..., None, :], disp)             # (..., N)
    c = dot3(disp, disp) - radii * radii

    radicand = b * b - 4.0 * a * c
    has_real = radicand >= 0

    root = safe_sqrt(radicand)
    denom = 2.0 * a
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)  # a==0 => no root
    u0 = (-b + root) / denom
    u1 = (-b - root) / denom

    big = torch.full_like(u0, K_SMALLEST_T_INIT)
    t0 = torch.where(has_real & (u0 > K_RAY_EPS), u0, big)
    t1 = torch.where(has_real & (u1 > K_RAY_EPS), u1, big)
    t = torch.minimum(t0, t1)
    return t, t < K_SMALLEST_T_INIT


@dataclasses.dataclass
class Hit:
    """Result of a closest-hit query, carrying the hit sphere's index."""

    found: torch.Tensor    # (...,) bool
    t: torch.Tensor        # (...,)
    point: torch.Tensor    # (..., 3)
    normal: torch.Tensor   # (..., 3) unit, outward
    sq_dist: torch.Tensor  # (...,) |t*d|^2 (raytracer.h:180-181)
    index: torch.Tensor    # (...,) int64, undefined where ~found


def closest_hit(origin, direction, spheres) -> Hit:
    """Batched calcIntersection (raytracer.h:145-194): t must be below
    kMaxRenderDist=1000, and on exact ties the lowest sphere index wins
    (argmin returns the first minimum)."""
    t_all, found_all = ray_sphere_t(origin, direction, spheres.pos, spheres.radius)
    valid = found_all & (t_all < K_MAX_RENDER_DIST)
    t_masked = torch.where(valid, t_all, torch.full_like(t_all, K_SMALLEST_T_INIT))
    index = torch.argmin(t_masked, dim=-1)
    found = torch.any(valid, dim=-1)
    t = torch.gather(t_masked, -1, index[..., None])[..., 0]
    t = torch.where(found, t, torch.full_like(t, K_MAX_RENDER_DIST))

    point = origin + t[..., None] * direction
    normal = normalize(point - spheres.pos[index])
    sq_dist = t * t * dot3(direction, direction)
    return Hit(found=found, t=t, point=point, normal=normal,
               sq_dist=sq_dist, index=index)


def primary_container(point, spheres):
    """Batched primaryContainer (raytracer.h:245-270): index of the first
    sphere whose (radius + 1e-6)-ball contains the point, else -1."""
    diff = point[..., None, :] - spheres.pos          # (..., N, 3)
    d2 = dot3(diff, diff)                             # (..., N)
    r = spheres.radius + K_CONTAIN_EPS
    inside = d2 <= r * r
    first = torch.argmax(inside.to(torch.uint8), dim=-1)
    return torch.where(torch.any(inside, dim=-1), first, torch.full_like(first, -1))
