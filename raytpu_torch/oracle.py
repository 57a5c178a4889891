"""Strict reference-semantics oracle in PyTorch (the counterpart of
raytpu.oracle), and the plain version of the oracle kernel (native.py,
csrc/oracle.cu).

It re-derives the reference's rayTrace stack machine (raytracer.h:410-636)
as a recursion with a stack budget, bug for bug, over a flat batch of rays
on the scene's device:

  * Stack-capacity truncation.  The reference's depth counter never grows,
    so recursion ends by silently dropping pushes on a full stack
    (raytraceStack.h:52-58; capacity 6 on the CPU build, 5 in the GPU
    kernel).  A node with `anc` ancestor resume-frames recurses while
    anc <= cap-2; at anc == cap-1 both pushes are dropped and the colourSum
    protocol double-counts the node's own emission: it returns 2m, or 4m
    when its reflection colour is significant.
  * The stale colourSum.  A ray that hits something with insignificant
    intensity leaves colourSum untouched (raytracer.h:458-460), so it
    returns its parent's partial colour.
  * NaN total internal reflection.  The TIR branch (raytracer.h:721-730)
    falls through to cosA2 = sqrt(1 - sinA2^2) = NaN; the Fresnel factor
    and the refracted intensity become NaN, isSignificant(NaN) is false,
    and a NaN-intensity miss paints NaN into the pixel.  Nothing here is
    NaN-safe, on purpose.
  * The background's opacity, which the reference never sets, is the
    caller's `bg_opacity` (default: the scene's).

Float32 discipline, as raytpu.oracle keeps it: every operation follows the
C operation order and width, one rounding per operation.  Dot products are
(ax*bx + ay*by) + az*bz; no fused operation stands in for two (no addcmul,
torch.dot or linalg reduction); a division by a scalar is written as the
exact product it equals (PyTorch's CUDA division by a host scalar is a
reciprocal multiply); the Fresnel intermediates are float64 under
`fresnel_double` (the CPU build, raytracer.h:380-384).  Every scalar
constant is the float32 value raytpu.oracle uses.  On the CPU and on a
card, the result equals raytpu.oracle's bit for bit, NaN mask included.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.device import resolve_device


def _f32(x) -> float:
    """The float32 value of `x`, as a Python float (exact)."""
    return float(np.float32(x))


K_RAY_EPS = _f32(1e-5)          # raytracer.h:86
K_MAX_RENDER_DIST = _f32(1e3)   # raytracer.h:156
K_SMALLEST_T = _f32(1e4)        # raytracer.h:119
K_CONTAIN_EPS = _f32(1e-6)      # raytracer.h:252
K_FRESNEL_EPS = _f32(1e-6)      # raytracer.h:376
K_MIN_INTENSITY = _f32(1e-3)    # raytracer.h:236
K_SMALL_SHIFT = _f32(0.01)      # raytracer.h:688, :831
TOL = _f32(1e-3)                # algebra.h:10
K_ALIGN_FLOOR = _f32(-0.1)      # raytracer.h:750
CPU_STACK_CAP = 6               # raytraceStack.h:10
GPU_STACK_CAP = 5               # raytrace_kernel.cl:58


class OracleScene:
    """The scene's fields as float32 tensors on its device, with the
    background opacity the caller gives (None: the scene's)."""

    def __init__(self, scene, bg_opacity=None, fresnel_double=True):
        # fresnel_double: CPU builds widen the Fresnel intermediates to
        # double (raytracer.h:380-384); the GPU kernel stays float
        # (raytrace_kernel.cl:409-410).
        self.fresnel_double = fresnel_double
        sp = scene.spheres
        f32 = lambda t: t.detach().to(torch.float32)
        self.pos = f32(sp.pos)
        self.radius = f32(sp.radius)
        self.matte = f32(sp.matte)
        self.gloss = f32(sp.gloss)
        self.opacity = f32(sp.opacity)
        self.ior = f32(sp.ior)
        self.lpos = f32(scene.lights.pos)
        self.lcol = f32(scene.lights.col)
        self.bg_matte = f32(scene.bg.matte)
        self.bg_ior = f32(scene.bg.ior)
        self.bg_opacity = (f32(scene.bg.opacity) if bg_opacity is None else
                           torch.tensor(_f32(bg_opacity), dtype=torch.float32,
                                        device=self.pos.device))

    @property
    def count(self) -> int:
        return self.pos.shape[0]


def _sqrt(x):
    """The correctly rounded float32 square root of a float32 or float64
    tensor, as C's sqrtf and (float)sqrt(double) give it.

    PyTorch's CPU sqrt is not correctly rounded (off by an ulp on ~0.6% of
    float32 inputs): the root is taken in float64, rounded to float32, and
    moved one ulp where the input lies beyond the square of the midpoint to
    its neighbour.  A midpoint of two adjacent float32 values has at most
    25 significant bits, so its square is exact in float64 and the test is
    exact.  NaN, infinities and zeros pass through."""
    r = torch.sqrt(x.double()).to(torch.float32)
    wide = x.double()
    up = torch.nextafter(r, torch.full_like(r, float("inf")))
    down = torch.nextafter(r, torch.zeros_like(r))
    hi = (r.double() + up.double()) * 0.5
    lo = (r.double() + down.double()) * 0.5
    r = torch.where(wide > hi * hi, up, r)
    return torch.where((r > 0) & (wide < lo * lo), down, r)


def _dot(ax, ay, az, bx, by, bz):
    """vdot (vec.h:40): left-to-right float32 sum."""
    return (ax * bx + ay * by) + az * bz


def _dot3(a, b):
    return _dot(a[:, 0], a[:, 1], a[:, 2], b[:, 0], b[:, 1], b[:, 2])


def _significant(c):
    """isSignificant (raytracer.h:235-241); NaN channels compare false."""
    return ((c[:, 0] >= K_MIN_INTENSITY) | (c[:, 1] >= K_MIN_INTENSITY)
            | (c[:, 2] >= K_MIN_INTENSITY))


def _ray_sphere(o, d, centre, radius):
    """raySphere (raytracer.h:81-141) for one sphere over all lanes."""
    dispx = o[:, 0] - centre[0]
    dispy = o[:, 1] - centre[1]
    dispz = o[:, 2] - centre[2]
    a = _dot(d[:, 0], d[:, 1], d[:, 2], d[:, 0], d[:, 1], d[:, 2])
    b = 2.0 * _dot(d[:, 0], d[:, 1], d[:, 2], dispx, dispy, dispz)
    c = _dot(dispx, dispy, dispz, dispx, dispy, dispz) - radius * radius
    rad = b * b - 4.0 * a * c
    ok_rad = rad >= 0
    root = _sqrt(torch.where(ok_rad, rad, 0.0))
    denom = 2.0 * a
    u0 = (-b + root) / denom
    u1 = (-b - root) / denom
    t = torch.full_like(a, K_SMALLEST_T)
    ok0 = ok_rad & (u0 > K_RAY_EPS) & (u0 < t)
    t = torch.where(ok0, u0, t)
    ok1 = ok_rad & (u1 > K_RAY_EPS) & (u1 < t)
    t = torch.where(ok1, u1, t)
    return t, ok0 | ok1


def _calc_intersection(o, d, sc):
    """calcIntersection (raytracer.h:145-194): running strict-< minimum over
    spheres in index order, starting at kMaxRenderDist."""
    n = o.shape[0]
    min_t = torch.full((n,), K_MAX_RENDER_DIST, dtype=torch.float32,
                       device=o.device)
    idx = torch.full((n,), -1, dtype=torch.int64, device=o.device)
    found = torch.zeros(n, dtype=torch.bool, device=o.device)
    for i in range(sc.count):
        t, ok = _ray_sphere(o, d, sc.pos[i], sc.radius[i])
        better = ok & (t < min_t)
        min_t = torch.where(better, t, min_t)
        idx = torch.where(better, i, idx)
        found = found | better
    safe = idx.clamp(min=0)
    point = o + min_t[:, None] * d
    nrm = point - sc.pos[safe]
    inv_len = torch.reciprocal(_sqrt(_dot3(nrm, nrm)))
    nrm = inv_len[:, None] * nrm
    dist = min_t[:, None] * d
    return found, min_t, point, nrm, _dot3(dist, dist), safe


def _clear_line_of_sight(a, b, sc):
    """hasClearLineOfSight (raytracer.h:272-309)."""
    dirv = b - a
    gap = _dot3(dirv, dirv)
    ray_d = torch.reciprocal(_sqrt(gap))[:, None] * dirv
    found, _, _, _, sq, _ = _calc_intersection(a, ray_d, sc)
    return ~(found & (sq < gap))


def _calculate_matte(point, normal, sc):
    """calculateMatte (raytracer.h:313-367)."""
    total = torch.zeros_like(point)
    for i in range(sc.lpos.shape[0]):
        lp = sc.lpos[i].expand(point.shape)
        clear = _clear_line_of_sight(point, lp, sc)
        dist = lp - point
        mag2 = _dot3(dist, dist)
        ldir = torch.reciprocal(_sqrt(mag2))[:, None] * dist
        incidence = _dot3(normal, ldir)
        intensity = incidence / mag2
        take = clear & (incidence > 0)
        total = total + torch.where(take[:, None], intensity[:, None] * sc.lcol[i],
                                    0.0)
    return total


def _polarised_reflection(n1, n2, cos1, cos2, double_prec=True):
    """polarisedReflection (raytracer.h:370-403).  CPU builds widen the
    numerator and denominator to double mid-expression; the GPU kernel
    (raytrace_kernel.cl:399-432) stays in float."""
    left = n1 * cos1
    right = n2 * cos2
    num = left - right
    den = left + right
    if double_prec:
        num, den = num.double(), den.double()
    den = den * den
    refl = ((num * num) / den).to(torch.float32)
    refl = torch.where(refl > 1.0, 1.0, refl)
    return torch.where(den < K_FRESNEL_EPS, 1.0, refl)


def _primary_container(pt, sc):
    """primaryContainer (raytracer.h:245-270): first containing sphere."""
    idx = torch.full((pt.shape[0],), -1, dtype=torch.int64, device=pt.device)
    for i in range(sc.count):
        r = sc.radius[i] + K_CONTAIN_EPS
        dist = pt - sc.pos[i]
        inside = _dot3(dist, dist) <= r * r
        idx = torch.where(inside & (idx == -1), i, idx)
    return idx


def _solve_quadratic(b, c):
    """solveQuadratic (algebra.h:22-65) with a == 1 (its only call in the
    tracer, raytracer.h:735-739) -> (root0, root1, nroots).  A negative
    radicand that is not "zero" gives NaN roots, like the C sqrt."""
    rad = b * b - 4.0 * c
    rad_zero = torch.abs(rad) < TOL
    root = _sqrt(rad)
    dbl = -b * 0.5
    r0 = torch.where(rad_zero, dbl, (-b + root) * 0.5)
    r1 = torch.where(rad_zero, dbl, (-b - root) * 0.5)
    nroots = torch.where(rad_zero, 1, 2)
    return r0, r1, nroots


def _calculate_refraction(point, normal, d, intensity, med_ior, sc):
    """calculateRefraction (raytracer.h:642-815) -> (origin, dir,
    child_intensity, target_matte, target_ior, target_opacity, factor); the
    factor is NaN under TIR, as in the C code where the fall-through
    overwrites the intended 1.0 (raytracer.h:726 vs :798)."""
    cos1_raw = _dot3(d, normal)
    cos1 = torch.clamp(cos1_raw, -1.0, 1.0)
    clamped = (cos1_raw <= -1.0) | (cos1_raw >= 1.0)
    # C: sqrt(1.0 - (cosA1*cosA1)): a float product, a double subtraction
    # and sqrt, a float assignment (raytracer.h:683).
    sin1 = _sqrt(1.0 - (cos1 * cos1).double())
    sin1 = torch.where(clamped, 0.0, sin1)

    probe = K_SMALL_SHIFT * d + point
    cont = _primary_container(probe, sc)
    safe = cont.clamp(min=0)
    inside = cont >= 0
    t_matte = torch.where(inside[:, None], sc.matte[safe], 0.0)
    t_ior = torch.where(inside, sc.ior[safe], 1.0)
    t_opacity = torch.where(inside, sc.opacity[safe], sc.bg_opacity)

    ratio = med_ior / t_ior
    sin2 = ratio * sin1

    r0, r1, nroots = _solve_quadratic(2.0 * cos1,
                                      1.0 - torch.reciprocal(ratio * ratio))

    # Root choice: strict '>' against maxAlignment, which starts at -0.1;
    # the direction stays (0,0,0) if no root qualifies (raytracer.h:750-771).
    max_align = torch.full_like(cos1, K_ALIGN_FLOOR)
    refr_dir = torch.zeros_like(d)
    for i, root in enumerate((r0, r1)):
        cand = d + root[:, None] * normal
        align = _dot3(d, cand)
        take = (align > max_align) & (nroots > i)
        max_align = torch.where(take, align, max_align)
        refr_dir = torch.where(take[:, None], cand, refr_dir)

    cos2 = _sqrt(1.0 - sin2 * sin2)  # NaN under TIR, like the C sqrt
    cos2 = torch.where(cos1 < 0, -cos2, cos2)

    rs = _polarised_reflection(med_ior, t_ior, cos1, cos2, sc.fresnel_double)
    rp = _polarised_reflection(med_ior, t_ior, cos2, cos1, sc.fresnel_double)
    factor = (rs + rp) * 0.5  # raytracer.h:798; exact in float or double

    child_i = (1.0 - factor)[:, None] * intensity
    return point, refr_dir, child_i, t_matte, t_ior, t_opacity, factor


def _calculate_reflection(point, normal, d):
    """calculateReflection (raytracer.h:817-842)."""
    perp = 2.0 * _dot3(d, normal)
    rd = d - perp[:, None] * normal
    rd = torch.reciprocal(_sqrt(_dot3(rd, rd)))[:, None] * rd
    return point + K_SMALL_SHIFT * rd, rd


def _trace(o, d, intensity, med_matte, med_ior, med_opacity, anc,
           parent_partial, sc, cap):
    """The stack machine as recursion with a budget (module docstring)."""
    found, _, point, normal, _, idx = _calc_intersection(o, d, sc)
    sig = _significant(intensity)

    mat_matte = sc.matte[idx]
    mat_gloss = sc.gloss[idx]
    opacity = sc.opacity[idx]
    transparency = 1.0 - opacity

    # Stage-0 emission (raytracer.h:463-484): the opaque part adds
    # opacity * I * matte * light-sum.
    calc = intensity * mat_matte
    calc = opacity[:, None] * calc
    calc = _calculate_matte(point, normal, sc) * calc
    m = torch.where((found & sig & (opacity > 0))[:, None], calc, 0.0)

    # Refraction (stage 0, raytracer.h:494-536): the incident ray carries
    # transparency * I.
    refr_in_i = transparency[:, None] * intensity
    r_o, r_d, r_i, tm, ti, to, factor = _calculate_refraction(
        point, normal, d, refr_in_i, med_ior, sc)

    # Reflection colour (stage 1, raytracer.h:563-578).
    prod = transparency * factor
    refl_col = prod[:, None].expand(intensity.shape)
    refl_col = refl_col + med_opacity[:, None] * mat_gloss
    refl_col = intensity * refl_col
    refl_sig = _significant(refl_col)

    if anc <= cap - 2:
        c = m + _trace(r_o, r_d, r_i, tm, ti, to, anc + 1, m, sc, cap)
        g_o, g_d = _calculate_reflection(point, normal, d)
        r2 = _trace(g_o, g_d, refl_col, med_matte, med_ior, med_opacity,
                    anc + 1, c, sc, cap)
        full = torch.where(refl_sig[:, None], c + r2, c)
    else:
        # anc == cap-1: both pushes dropped; the colourSum protocol
        # double-counts m at stage 1, and again at stage 2 if the
        # reflection colour is significant.
        two_m = m + m
        full = torch.where(refl_sig[:, None], two_m + two_m, two_m)

    miss_val = intensity * med_matte
    return torch.where(
        ~found[:, None], miss_val,
        torch.where(~sig[:, None], parent_partial,
                    torch.where((transparency > 0)[:, None], full, m)))


def trace_oracle(scene, origins, dirs, cap=CPU_STACK_CAP, bg_opacity=None,
                 fresnel_double=True):
    """Trace a flat (B, 3) ray batch with strict reference semantics on the
    scene's device -> (B, 3) float32.  `origins` is (3,) or (B, 3)."""
    sc = OracleScene(scene, bg_opacity, fresnel_double)
    dev = sc.pos.device
    d = torch.as_tensor(dirs, dtype=torch.float32, device=dev)
    b = d.shape[0]
    o = torch.as_tensor(origins, dtype=torch.float32, device=dev).expand(b, 3)
    return _trace(o, d, torch.ones((b, 3), dtype=torch.float32, device=dev),
                  sc.bg_matte.expand(b, 3), sc.bg_ior.expand(b),
                  sc.bg_opacity.expand(b), 0,
                  torch.zeros((b, 3), dtype=torch.float32, device=dev), sc, cap)


def camera_dirs_oracle(cfg, sample_i, sample_j, device=None):
    """Float32-exact camera directions (raytrace_kernel.cl:908-952,
    main.cpp:404-447): one (P, 3) tensor for supersample (i, j), on
    `device` (None: this process's card, device.local_device)."""
    device = resolve_device(device)
    F = np.float32
    w, h = cfg.width, cfg.height
    xstep = F(cfg.image_world_width) / F(w)
    ystep = F(cfg.image_world_height) / F(h)
    aspect = F(cfg.image_world_width) / F(cfg.image_world_height)
    sub = xstep / F(cfg.alias_factor)
    gid = torch.arange(w * h, dtype=torch.int64, device=device)
    px = ((gid % w).to(torch.float32) - float(F(w) * F(0.5))) * float(xstep)
    py = (float(F(h) * F(0.5)) - (gid // w).to(torch.float32)) * float(ystep)
    x = (px + float(F(sample_j) * sub)) * float(aspect)
    y = py + float(F(sample_i) * sub)
    z = torch.full_like(x, _f32(cfg.zoom))
    inv = torch.reciprocal(_sqrt(_dot(x, y, z, x, y, z)))
    return torch.stack([x * inv, y * inv, z * inv], dim=-1)


def render_oracle(scene, cfg, cap=CPU_STACK_CAP, bg_opacity=None,
                  fresnel_double=True):
    """Full-frame strict render on the scene's device -> (H, W, 3) float32
    linear colour, the samples added in the order of (i, j) as
    raytpu.oracle adds them.

    The defaults model the reference CPU build; cap=5, bg_opacity=0.0 and
    fresnel_double=False model the GPU build that rendered the primary
    golden (tests/test_golden.py).  The plain version of
    raytpu_torch.native.render_native, which launches the oracle kernel.
    """
    dev = scene.device
    acc = torch.zeros((cfg.num_pixels, 3), dtype=torch.float32, device=dev)
    weight = float(np.float32(1.0) / np.float32(cfg.alias_factor * cfg.alias_factor))
    origin = torch.zeros(3, dtype=torch.float32, device=dev)
    for i in range(cfg.alias_factor):
        for j in range(cfg.alias_factor):
            dirs = camera_dirs_oracle(cfg, i, j, dev)
            col = trace_oracle(scene, origin, dirs, cap, bg_opacity,
                               fresnel_double)
            acc = acc + weight * col
    return acc.reshape(cfg.height, cfg.width, 3)
