"""Scalar algebra: tolerance compares and the quadratic solver.

Reference: algebra.h — TOL=1e-3 (algebra.h:10), isZero (algebra.h:12-14),
solveQuadratic (algebra.h:22-65).  The branchless form returns a
fixed-shape pair (roots[..., 2], nroots[...]); see raytpu.ops.algebra.
"""

from __future__ import annotations

import torch

TOL = 1e-3


def is_zero(x):
    """|x| < 1e-3, as algebra.h:12-14."""
    return torch.abs(x) < TOL


def _safe_div(num, den):
    """num/den with a guarded denominator; the caller masks den==0 lanes.
    The double-where keeps reverse-mode gradients finite on masked lanes."""
    return num / torch.where(den == 0, 1.0, den)


def safe_sqrt(x):
    """sqrt(x) for x > 0, else 0 — with the double-where so reverse-mode AD
    sees a finite derivative on the clamped branch (sqrt'(0) is infinite,
    and inf * 0 from a mask is NaN without the inner where)."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def solve_quadratic(a, b, c):
    """Solve a*x^2 + b*x + c = 0 with the reference's branch structure
    (algebra.h:22-65), vectorized over any batch shape:

      * isZero(a) and isZero(b)  -> 0 roots
      * isZero(a)                -> 1 root: -c/b
      * isZero(radicand)         -> 1 root: -b/(2a)
      * otherwise two roots, with the radicand clamped at zero (the callers
        mask total internal reflection explicitly).  roots[0] =
        (-b + sqrt(r))/(2a), roots[1] = (-b - sqrt(r))/(2a).

    Returns:
      roots: (..., 2) float32; nroots: (...,) int32 in {0, 1, 2}.
    """
    a_zero = is_zero(a)
    b_zero = is_zero(b)
    lin_root = _safe_div(-c, b)

    radicand = b * b - 4.0 * a * c
    rad_zero = is_zero(radicand)
    dbl_root = _safe_div(-b, 2.0 * a)

    root = safe_sqrt(radicand)
    denom = 2.0 * a
    r0 = _safe_div(-b + root, denom)
    r1 = _safe_div(-b - root, denom)

    nroots = torch.where(a_zero, torch.where(b_zero, 0, 1),
                         torch.where(rad_zero, 1, 2)).to(torch.int32)
    root0 = torch.where(a_zero, lin_root, torch.where(rad_zero, dbl_root, r0))
    root1 = torch.where(a_zero, lin_root, torch.where(rad_zero, dbl_root, r1))
    return torch.stack([root0, root1], dim=-1), nroots
