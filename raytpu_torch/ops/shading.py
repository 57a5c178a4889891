"""Shading: Lambert matte with shadow rays, Fresnel, reflect, refract.

Reference semantics (batched, masked), as raytpu.ops.shading:
  * isSignificant        raytracer.h:235-241
  * hasClearLineOfSight  raytracer.h:272-309
  * calculateMatte       raytracer.h:313-367
  * polarisedReflection  raytracer.h:370-403
  * calculateRefraction  raytracer.h:642-815
  * calculateReflection  raytracer.h:817-842

Under total internal reflection the factor is 1 and the refracted ray is
dead (the clean mode; the reference's NaN lives only in the numpy oracle).
Every masked sqrt and divide keeps its double-where guard: torch.where has
the same NaN-gradient trap as jnp.where.
"""

from __future__ import annotations

import torch

from raytpu_torch.ops.algebra import safe_sqrt, solve_quadratic
from raytpu_torch.ops.geometry import (
    K_MAX_RENDER_DIST,
    dot3,
    normalize,
    primary_container,
    ray_sphere_t,
)

K_MIN_INTENSITY = 1e-3  # kMinOpticalIntesity, raytracer.h:236
K_SMALL_SHIFT = 0.01    # raytracer.h:688, :831
K_FRESNEL_EPS = 1e-6    # raytracer.h:376


def is_significant(colour):
    """Any channel >= 0.001 (raytracer.h:235-241)."""
    return torch.any(colour >= K_MIN_INTENSITY, dim=-1)


def polarised_reflection(n1, n2, cos_a1, cos_a2):
    """Fresnel coefficient ((n1 c1 - n2 c2)/(n1 c1 + n2 c2))^2, capped at 1,
    with a denominator ~ 0 meaning full reflection (raytracer.h:370-403)."""
    left = n1 * cos_a1
    right = n2 * cos_a2
    num = left - right
    den = left + right
    den2 = den * den
    small = den2 < K_FRESNEL_EPS
    one = torch.ones_like(den2)
    refl = torch.clamp(num * num / torch.where(small, one, den2), max=1.0)
    return torch.where(small, one, refl)


def matte_light_sum(point, normal, spheres, lights):
    """Sum over lights of (incidence / dist^2) * light.col for unshadowed
    lights (calculateMatte, raytracer.h:313-367).  A light is shadowed when
    some sphere has a root t in (1e-5, 1000) with t^2 < |light-point|^2 along
    the unit shadow ray (raytracer.h:272-309).

    Args:
      point, normal: (..., 3) hit positions / unit normals.
    Returns:
      (..., 3) colour sum (zero where shadowed or back-facing).
    """
    dist = lights.pos - point[..., None, :]        # (..., L, 3)
    gap = dot3(dist, dist)                         # (..., L)
    ldir = normalize(dist)

    t, found = ray_sphere_t(point[..., None, :], ldir, spheres.pos, spheres.radius)
    blocking = found & (t < K_MAX_RENDER_DIST) & (t * t < gap[..., None])
    clear = ~torch.any(blocking, dim=-1)           # (..., L)

    incidence = dot3(normal[..., None, :], ldir)   # (..., L)
    # Double-where on the divide: gap == 0 lanes are masked (incidence 0).
    gap_safe = torch.where(gap == 0, torch.ones_like(gap), gap)
    weight = torch.where(clear & (incidence > 0), incidence / gap_safe,
                         torch.zeros_like(gap))
    return torch.sum(weight[..., None] * lights.col, dim=-2)


def reflect(direction, normal, point):
    """Mirror bounce (calculateReflection, raytracer.h:817-842): reflected
    direction normalized, origin shifted 0.01 along it."""
    perp = 2.0 * dot3(direction, normal)
    refl_dir = normalize(direction - perp[..., None] * normal)
    return point + K_SMALL_SHIFT * refl_dir, refl_dir


def refract(point, normal, direction, medium_ior, spheres, bg):
    """Snell refraction via the reference's quadratic-solve formulation
    (calculateRefraction, raytracer.h:642-815), batched and NaN-free.

      * cosA1 = dir.normal clamped to [-1, 1]; `direction` is used raw
        (refracted parents are unnormalized), so cosA1 can hit the clamps.
      * The probe point + 0.01*dir finds the target medium by
        primaryContainer, else the background.  The refracted ray's own
        origin is NOT shifted.
      * |sinA2| >= 1 is total internal reflection: factor 1, dead child.
      * Direction = dir + k*normal with k a root of
        k^2 + 2 cosA1 k + (1 - 1/ratio^2) = 0, the root whose direction best
        aligns with the incident one; if neither beats -0.1 the direction
        is zero.  It is left unnormalized, like the reference.
      * Fresnel factor = (Rs + Rp)/2.

    Returns:
      (refr_origin, refr_dir, reflection_factor, target_idx), target_idx
      the containing sphere's index or -1 for the background.
    """
    one = torch.ones_like(direction[..., 0])
    cos_a1 = torch.clamp(dot3(direction, normal), -1.0, 1.0)
    sin_a1 = safe_sqrt(one - cos_a1 * cos_a1)

    probe = point + K_SMALL_SHIFT * direction
    target_idx = primary_container(probe, spheres)
    in_sphere = target_idx >= 0
    target_ior = torch.where(in_sphere, spheres.ior[torch.clamp(target_idx, min=0)],
                             bg.ior)

    ratio = medium_ior / torch.where(target_ior == 0, one, target_ior)
    sin_a2 = ratio * sin_a1
    tir = (sin_a2 <= -1.0) | (sin_a2 >= 1.0)

    ratio2 = ratio * ratio
    ratio2 = torch.where(ratio2 == 0, one, ratio2)
    roots, nroots = solve_quadratic(one, 2.0 * cos_a1, one - one / ratio2)

    # Strict '>' against a running max initialised to -0.1
    # (raytracer.h:750-771): root 1 replaces root 0 only on a strictly
    # larger alignment, and if neither beats -0.1 the direction is zero.
    cand0 = direction + roots[..., 0:1] * normal
    cand1 = direction + roots[..., 1:2] * normal
    neg_inf = torch.full_like(one, -float("inf"))
    align0 = torch.where(nroots >= 1, dot3(direction, cand0), neg_inf)
    align1 = torch.where(nroots >= 2, dot3(direction, cand1), neg_inf)
    floor = torch.full_like(one, -0.1)
    take0 = align0 > floor
    take1 = align1 > torch.maximum(align0, floor)
    refr_dir = torch.where(
        take1[..., None], cand1,
        torch.where(take0[..., None], cand0, torch.zeros_like(direction)))

    cos_a2 = safe_sqrt(one - sin_a2 * sin_a2)
    cos_a2 = torch.where(cos_a1 < 0, -cos_a2, cos_a2)

    rs = polarised_reflection(medium_ior, target_ior, cos_a1, cos_a2)
    rp = polarised_reflection(medium_ior, target_ior, cos_a2, cos_a1)
    reflection_factor = torch.where(tir, one, 0.5 * (rs + rp))
    return point, refr_dir, reflection_factor, target_idx
