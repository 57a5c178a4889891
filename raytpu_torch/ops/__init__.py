"""Differentiable, branchless building blocks of the eager tracer: per-lane
control flow from the reference (C `if`s in raytracer.h) becomes
`torch.where` over batched tensors."""

from raytpu_torch.ops.algebra import is_zero, solve_quadratic
from raytpu_torch.ops.geometry import Hit, closest_hit, primary_container, ray_sphere_t
from raytpu_torch.ops.shading import (
    is_significant,
    matte_light_sum,
    polarised_reflection,
    reflect,
    refract,
)

__all__ = [
    "is_zero", "solve_quadratic",
    "ray_sphere_t", "closest_hit", "primary_container", "Hit",
    "polarised_reflection", "reflect", "refract", "matte_light_sum",
    "is_significant",
]
