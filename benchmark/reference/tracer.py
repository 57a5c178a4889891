"""The benchmark's plain reference: the Whitted tracer of
snowzurfer/raytracer-gamma in plain PyTorch, its MSE loss, its scene
gradient and the fit's Adam steps.

It imports nothing of the program.  Its arithmetic is a frozen copy of the
semantics the program states (raytracer.h's ray-sphere test, closest hit,
shadow rays, Lambert matte, Fresnel reflect and refract, significance
gates; main.cpp's camera), op for op in the order that the program's plain
version rounds them, so that the two agree to rounding.  Its structure is
its own:

  * every camera sample is a ray of one flat batch; a level holds only the
    rays whose intensity is not all exactly zero (a ray of zero intensity
    emits exact zeros and spawns nothing), and each ray carries the index
    of its camera sample, into which its emission is added;
  * the discrete selections (the closest sphere, the shadow blockers, the
    container of a refraction probe) are constants of the derivative, so
    they are taken without autograd over (rays, spheres) blocks, and the
    chosen sphere's root is computed again, with autograd, by the same
    operations: the values are the same, and autograd holds per-ray
    tensors only;
  * the frame runs in blocks of camera samples, each block's loss
    differentiated on its own, so that memory holds one block's tree.

A scene is a dict of the 11 leaf tensors keyed as LEAF_NAMES.  `dtype`
(float32 by default) is the precision of every float; the benchmark's
control runs the same code in bfloat16.
"""

from __future__ import annotations

import math

import torch

LEAF_NAMES = ("spheres.pos", "spheres.radius", "spheres.matte",
              "spheres.gloss", "spheres.opacity", "spheres.ior",
              "lights.pos", "lights.col", "bg.matte", "bg.ior", "bg.opacity")

K_RAY_EPS = 1e-5         # raytracer.h:86
K_SMALLEST_T_INIT = 1e4  # raytracer.h:119
K_MAX_RENDER_DIST = 1e3  # raytracer.h:156
K_CONTAIN_EPS = 1e-6     # raytracer.h:252
K_MIN_INTENSITY = 1e-3   # raytracer.h:236
K_SMALL_SHIFT = 0.01     # raytracer.h:688, :831
K_FRESNEL_EPS = 1e-6     # raytracer.h:376
TOL = 1e-3               # algebra.h:10

# Elements of one (rays, spheres) temporary in the no-grad selections.
SELECT_ELEMENTS = 1 << 26


# ---------------------------------------------------------------- algebra

def dot3(a, b):
    p = a * b
    return (p[..., 0] + p[..., 1]) + p[..., 2]


def normalize(v):
    n2 = dot3(v, v)
    n2 = torch.where(n2 == 0, torch.ones_like(n2), n2)
    return v * (1.0 / torch.sqrt(n2))[..., None]


def safe_sqrt(x):
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, 1.0)), 0.0)


def _safe_div(num, den):
    return num / torch.where(den == 0, 1.0, den)


def solve_quadratic(a, b, c):
    """algebra.h:22-65: (roots (..., 2), number of roots)."""
    a_zero = torch.abs(a) < TOL
    b_zero = torch.abs(b) < TOL
    lin_root = _safe_div(-c, b)
    radicand = b * b - 4.0 * a * c
    rad_zero = torch.abs(radicand) < TOL
    dbl_root = _safe_div(-b, 2.0 * a)
    root = safe_sqrt(radicand)
    denom = 2.0 * a
    r0 = _safe_div(-b + root, denom)
    r1 = _safe_div(-b - root, denom)
    nroots = torch.where(a_zero, torch.where(b_zero, 0, 1),
                         torch.where(rad_zero, 1, 2))
    root0 = torch.where(a_zero, lin_root, torch.where(rad_zero, dbl_root, r0))
    root1 = torch.where(a_zero, lin_root, torch.where(rad_zero, dbl_root, r1))
    return torch.stack([root0, root1], dim=-1), nroots


def sphere_t(origin, direction, centers, radii):
    """raySphere (raytracer.h:81-141): the smallest root above 1e-5, else
    1e4, and whether there is one.  Shapes broadcast: (..., 3) rays against
    (..., 3) centres."""
    disp = origin - centers
    a = dot3(direction, direction)
    b = 2.0 * dot3(direction, disp)
    c = dot3(disp, disp) - radii * radii
    radicand = b * b - 4.0 * a * c
    has_real = radicand >= 0
    root = safe_sqrt(radicand)
    denom = 2.0 * a
    denom = torch.where(denom == 0, torch.ones_like(denom), denom)
    u0 = (-b + root) / denom
    u1 = (-b - root) / denom
    big = torch.full_like(u0, K_SMALLEST_T_INIT)
    t0 = torch.where(has_real & (u0 > K_RAY_EPS), u0, big)
    t1 = torch.where(has_real & (u1 > K_RAY_EPS), u1, big)
    t = torch.minimum(t0, t1)
    return t, t < K_SMALLEST_T_INIT


def _row_blocks(rows: int, width: int):
    step = max(1, SELECT_ELEMENTS // max(width, 1))
    return range(0, rows, step), step


def closest_sphere(origin, direction, pos, radius):
    """calcIntersection's choice (raytracer.h:145-194), without autograd:
    (index of the closest valid sphere, found).  Ties go to the lowest
    index."""
    n = pos.shape[0]
    idx = torch.empty(origin.shape[0], dtype=torch.int64, device=origin.device)
    found = torch.empty(origin.shape[0], dtype=torch.bool, device=origin.device)
    starts, step = _row_blocks(origin.shape[0], n)
    with torch.no_grad():
        for s in starts:
            o, d = origin[s:s + step, None, :], direction[s:s + step, None, :]
            t, ok = sphere_t(o, d, pos, radius)
            valid = ok & (t < K_MAX_RENDER_DIST)
            t = torch.where(valid, t, torch.full_like(t, K_SMALLEST_T_INIT))
            idx[s:s + step] = torch.argmin(t, dim=-1)
            found[s:s + step] = valid.any(dim=-1)
    return idx, found


def first_true(mask, n):
    """Tests made until the first True along the last axis, else n."""
    first = torch.argmax(mask.to(torch.uint8), dim=-1) + 1
    return torch.where(mask.any(dim=-1), first, torch.full_like(first, n))


def shadow_clear(point, ldir, gap, pos, radius, count=None):
    """hasClearLineOfSight (raytracer.h:272-309) for every (ray, light),
    without autograd: no sphere has a root in (1e-5, 1000) with t^2 below
    the squared light distance.  `count`, if given, is (facing mask, work
    dict): the shadow tests made until the first blocker are added to
    work["shadow_sphere"]."""
    rays, nl = point.shape[0], ldir.shape[1]
    n = pos.shape[0]
    clear = torch.empty((rays, nl), dtype=torch.bool, device=point.device)
    starts, step = _row_blocks(rays, nl * n)
    with torch.no_grad():
        for s in starts:
            t, ok = sphere_t(point[s:s + step, None, None, :],
                             ldir[s:s + step, :, None, :], pos, radius)
            blocking = ok & (t < K_MAX_RENDER_DIST) & (
                t * t < gap[s:s + step, :, None])
            clear[s:s + step] = ~blocking.any(dim=-1)
            if count is not None:
                facing, work = count
                work["shadow_sphere"] += int(
                    first_true(blocking, n)[facing[s:s + step]].sum())
    return clear


def container(probe, pos, radius, count=None):
    """primaryContainer (raytracer.h:245-270), without autograd: the first
    sphere whose (radius + 1e-6)-ball holds the point, else -1.  `count`,
    if given, is (spawning mask, work dict): the containment tests made
    until the first container are added to work["container"]."""
    n = pos.shape[0]
    out = torch.empty(probe.shape[0], dtype=torch.int64, device=probe.device)
    starts, step = _row_blocks(probe.shape[0], n)
    with torch.no_grad():
        for s in starts:
            p = probe[s:s + step, None, :]
            diff = p - pos
            r = radius + K_CONTAIN_EPS
            inside = dot3(diff, diff) <= r * r
            first = torch.argmax(inside.to(torch.uint8), dim=-1)
            out[s:s + step] = torch.where(inside.any(dim=-1), first,
                                          torch.full_like(first, -1))
            if count is not None:
                spawning, work = count
                # chip_smoke.py's count: squares summed by torch.sum.
                ins = ((p - pos) ** 2).sum(-1) <= (radius + 1e-6) ** 2
                work["container"] += int(first_true(ins, n)[spawning[s:s + step]].sum())
    return out


# ---------------------------------------------------------------- shading

def is_significant(colour):
    return torch.any(colour >= K_MIN_INTENSITY, dim=-1)


def polarised_reflection(n1, n2, cos_a1, cos_a2):
    left = n1 * cos_a1
    right = n2 * cos_a2
    num = left - right
    den = left + right
    den2 = den * den
    small = den2 < K_FRESNEL_EPS
    one = torch.ones_like(den2)
    refl = torch.clamp(num * num / torch.where(small, one, den2), max=1.0)
    return torch.where(small, one, refl)


def medium(scene, index):
    """The medium fields (matte, ior, opacity) of sphere `index`, or of the
    background where it is -1 (raytracer.h:699-707)."""
    safe = torch.clamp(index, min=0)
    inside = index >= 0
    matte = torch.where(inside[:, None], scene["spheres.matte"][safe],
                        scene["bg.matte"])
    ior = torch.where(inside, scene["spheres.ior"][safe], scene["bg.ior"])
    opacity = torch.where(inside, scene["spheres.opacity"][safe],
                          scene["bg.opacity"])
    return matte, ior, opacity


def refract(scene, point, normal, direction, medium_ior, target_idx):
    """calculateRefraction (raytracer.h:642-815) with the target medium
    already found: (direction, Fresnel reflection factor)."""
    one = torch.ones_like(direction[..., 0])
    cos_a1 = torch.clamp(dot3(direction, normal), -1.0, 1.0)
    sin_a1 = safe_sqrt(one - cos_a1 * cos_a1)
    in_sphere = target_idx >= 0
    target_ior = torch.where(
        in_sphere, scene["spheres.ior"][torch.clamp(target_idx, min=0)],
        scene["bg.ior"])
    ratio = medium_ior / torch.where(target_ior == 0, one, target_ior)
    sin_a2 = ratio * sin_a1
    tir = (sin_a2 <= -1.0) | (sin_a2 >= 1.0)
    ratio2 = ratio * ratio
    ratio2 = torch.where(ratio2 == 0, one, ratio2)
    roots, nroots = solve_quadratic(one, 2.0 * cos_a1, one - one / ratio2)
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
    return refr_dir, torch.where(tir, one, 0.5 * (rs + rp))


# ---------------------------------------------------------------- tracing

def camera_constants(cfg: dict, dtype):
    """The camera scalars of raytrace_kernel.cl:908-968, each rounded in
    `dtype` as the program rounds them in float32."""
    def f(x):
        return torch.tensor(x, dtype=torch.float64).to(dtype)

    w, h = f(cfg["width"]), f(cfg["height"])
    xstep = f(cfg["image_world_width"]) / w
    return dict(xstep=xstep, ystep=f(cfg["image_world_height"]) / h,
                aspect=f(cfg["image_world_width"]) / f(cfg["image_world_height"]),
                sub=xstep / f(cfg["alias_factor"]), half_w=w * f(0.5),
                half_h=h * f(0.5), zoom=f(cfg["zoom"]),
                weight=f(1.0 / cfg["alias_factor"] ** 2))


def camera_samples(cfg: dict, first: int, count: int, device, dtype):
    """Unit directions of camera samples first .. first+count-1, sample k
    being pixel k // spp's supersample (k % spp) // alias, (k % spp) %
    alias."""
    a = cfg["alias_factor"]
    spp = a * a
    c = {k: v.to(device) for k, v in camera_constants(cfg, dtype).items()}
    k = torch.arange(first, first + count, dtype=torch.int64, device=device)
    gid, s = k // spp, k % spp
    ix = (gid % cfg["width"]).to(dtype)
    iy = (gid // cfg["width"]).to(dtype)
    px = (ix - c["half_w"]) * c["xstep"]
    py = (c["half_h"] - iy) * c["ystep"]
    x = (px + (s % a).to(dtype) * c["sub"]) * c["aspect"]
    y = py + (s // a).to(dtype) * c["sub"]
    z = torch.full_like(x, 0.0) + c["zoom"]
    return normalize(torch.stack([x, y, z], dim=-1))


def trace_level(scene, rays, spawn: bool, work=None):
    """One bounce level of the live rays `rays` = (origin, direction,
    intensity, medium index, camera sample index): (emission (R, 3),
    children or None).  Children are the refraction and reflection
    children whose intensity is not all exactly zero.  `work`, if given,
    gathers chip_smoke.py's work units of the level."""
    origin, direction, intensity, med_idx, sample = rays
    pos, radius = scene["spheres.pos"], scene["spheres.radius"]
    n = pos.shape[0]
    med_matte, med_ior, med_opacity = medium(scene, med_idx)
    idx, found = closest_sphere(origin.detach(), direction.detach(),
                                pos.detach(), radius.detach())
    emission = torch.where(found[:, None], torch.zeros_like(intensity),
                           intensity * med_matte)
    if work is not None:
        work["node"] += origin.shape[0]
        work["sphere"] += origin.shape[0] * n
        work["miss"] += int((~found).sum())
    h = torch.nonzero(found)[:, 0]
    if h.numel() == 0:
        return emission, None
    o, d, inten, hi = origin[h], direction[h], intensity[h], idx[h]
    t, _ = sphere_t(o, d, pos[hi], radius[hi])
    point = o + t[:, None] * d
    normal = normalize(point - pos[hi])
    opacity = scene["spheres.opacity"][hi]
    transparency = 1.0 - opacity
    live = is_significant(inten)

    # The matte term of the live hits facing a light (calculateMatte).
    shaded = live & (opacity > 0)
    lights_pos, lights_col = scene["lights.pos"], scene["lights.col"]
    dist = lights_pos - point[:, None, :]
    gap = dot3(dist, dist)
    ldir = normalize(dist)
    incidence = dot3(normal[:, None, :], ldir)
    # Only a shaded hit's light facing its surface takes a shadow ray: the
    # other (ray, light) pairs weigh nothing whatever the test says.
    facing = shaded[:, None] & (incidence > 0)
    rows = torch.nonzero(facing.any(dim=-1))[:, 0]
    if work is not None:
        work["live"] += int(live.sum())
        work["shaded"] += int(shaded.sum())
        work["light"] += int(shaded.sum()) * lights_pos.shape[0]
        work["shadow"] += int(facing.sum())
    clear = torch.zeros_like(facing)
    clear[rows] = shadow_clear(point.detach()[rows], ldir.detach()[rows],
                               gap.detach()[rows], pos.detach(), radius.detach(),
                               None if work is None else (facing[rows], work))
    if work is not None:
        work["lit"] += int((facing & clear).sum())
    gap_safe = torch.where(gap == 0, torch.ones_like(gap), gap)
    weight = torch.where(clear & (incidence > 0), incidence / gap_safe,
                         torch.zeros_like(gap))
    light_sum = torch.sum(weight[..., None] * lights_col, dim=-2)
    zero = torch.zeros_like(inten)
    matte = torch.where(shaded[:, None],
                        opacity[:, None] * inten * scene["spheres.matte"][hi]
                        * light_sum, zero)
    emission = emission.index_add(0, h, matte)
    if not spawn:
        return emission, None

    # The children (calculateRefraction, calculateReflection) of the
    # spawning hits; the others' children carry exact zeros.
    spawning = live & (transparency > 0)
    if work is not None:
        work["spawn"] += int(spawning.sum())
    sp = torch.nonzero(spawning)[:, 0]
    point, normal, d, inten = point[sp], normal[sp], d[sp], inten[sp]
    transparency, hs = transparency[sp], h[sp]
    probe = point + K_SMALL_SHIFT * d
    target = container(probe.detach(), pos.detach(), radius.detach(),
                       None if work is None else (
                           torch.ones_like(sp, dtype=torch.bool), work))
    refr_dir, refl_factor = refract(scene, point, normal, d, med_ior[hs],
                                    target)
    r_inten = (transparency * (1.0 - refl_factor))[:, None] * inten
    refl_col = ((transparency * refl_factor)[:, None]
                + med_opacity[hs][:, None] * scene["spheres.gloss"][hi[sp]]) * inten
    refl_gate = is_significant(refl_col)
    perp = 2.0 * dot3(d, normal)
    g_dir = normalize(d - perp[:, None] * normal)
    g_origin = point + K_SMALL_SHIFT * g_dir
    g_inten = torch.where(refl_gate[:, None], refl_col, torch.zeros_like(inten))

    r_alive = (r_inten != 0).any(dim=-1)
    g_alive = (g_inten != 0).any(dim=-1)
    if work is not None:
        work["refr"] += int(r_alive.sum())
        work["refl"] += int(g_alive.sum())
    r, g = torch.nonzero(r_alive)[:, 0], torch.nonzero(g_alive)[:, 0]
    children = (torch.cat([point[r], g_origin[g]]),
                torch.cat([refr_dir[r], g_dir[g]]),
                torch.cat([r_inten[r], g_inten[g]]),
                torch.cat([target[r], med_idx[hs][g]]),
                torch.cat([sample[hs][r], sample[hs][g]]))
    if children[0].shape[0] == 0:
        return emission, None
    return emission, children


def trace_samples(scene, cfg: dict, first: int, count: int, work=None):
    """The linear colour of camera samples first .. first+count-1: (count,
    3), every level's emission added into its sample."""
    dtype = scene["spheres.pos"].dtype
    device = scene["spheres.pos"].device
    d = camera_samples(cfg, first, count, device, dtype)
    if work is not None:
        work["sample"] += count
    rays = (torch.zeros_like(d), d, torch.ones_like(d),
            torch.full((count,), -1, dtype=torch.int64, device=device),
            torch.arange(count, device=device))
    colour = torch.zeros((count, 3), dtype=dtype, device=device)
    for level in range(cfg["max_depth"] + 1):
        emission, children = trace_level(scene, rays, level < cfg["max_depth"],
                                         work)
        colour = colour.index_add(0, rays[4], emission)
        if children is None:
            break
        rays = children
    return colour


def pixel_sum(colour, weight, pixels: int, spp: int):
    """Each pixel's weighted samples added in the order of the sample, as
    raytrace_kernel.cl:945-968 adds them: (pixels, 3)."""
    wc = (weight.to(colour.device) * colour).reshape(pixels, spp, 3)
    acc = torch.zeros_like(wc[:, 0])
    for s in range(spp):
        acc = acc + wc[:, s]
    return acc


def _pixel_blocks(cfg: dict, block_pixels: int, pixels=None):
    """(first pixel, pixel count) blocks of the frame, or of the pixel
    range `pixels` = (first, count)."""
    first, total = (0, cfg["width"] * cfg["height"]) if pixels is None else pixels
    for p in range(first, first + total, block_pixels):
        yield p, min(block_pixels, first + total - p)


def render(scene, cfg: dict, block_pixels: int = 1 << 16, pixels=None,
           work=None):
    """The frame's linear colour, (P, 3) in pixel order, or that of the
    pixel range `pixels` = (first, count); no autograd."""
    spp = cfg["alias_factor"] ** 2
    weight = camera_constants(cfg, scene["spheres.pos"].dtype)["weight"]
    out = []
    with torch.no_grad():
        for p, m in _pixel_blocks(cfg, block_pixels, pixels):
            colour = trace_samples(scene, cfg, p * spp, m * spp, work)
            out.append(pixel_sum(colour, weight, m, spp))
    return torch.cat(out)


def loss_and_grad(scene, cfg: dict, target, block_pixels: int = 1 << 16,
                  pixels=None, work=None):
    """The fit's loss, sum((pixel - target)^2) / (3P) over the frame's P
    pixels, and its gradient with respect to every leaf: (loss as a float64
    tensor, {name: gradient}).  `pixels` = (first, count) takes the loss
    and gradient of that pixel range's share only (the terms are still
    divided by 3P).  `work` as in render."""
    spp = cfg["alias_factor"] ** 2
    p_all = cfg["width"] * cfg["height"]
    dtype = scene["spheres.pos"].dtype
    weight = camera_constants(cfg, dtype)["weight"]
    leaves = {k: v.detach().requires_grad_(True) for k, v in scene.items()}
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    total = torch.zeros((), dtype=torch.float64, device=target.device)
    for p, m in _pixel_blocks(cfg, block_pixels, pixels):
        with torch.enable_grad():
            colour = trace_samples(leaves, cfg, p * spp, m * spp, work)
            pixel = pixel_sum(colour, weight, m, spp)
            err = pixel - target[p:p + m].to(dtype)
            loss = torch.sum(err * err) / (3 * p_all)
            got = torch.autograd.grad(loss, list(leaves.values()),
                                      allow_unused=True)
        for (k, _), g in zip(leaves.items(), got):
            if g is not None:
                grads[k] += g
        total += loss.detach().double()
    return total, grads


def fit(scene, cfg: dict, target, steps: int, learning_rate: float,
        block_pixels: int = 1 << 16, pixels=None, reduce=None, work=None):
    """`steps` steps of the gradient fit from `scene` with
    torch.optim.Adam(lr=learning_rate), as the fit task states it: (losses,
    the first step's gradient {name: tensor}, the leaves after the last
    step {name: tensor}).  With `pixels` = (first, count) this process
    takes that share of each step's loss and gradient, and `reduce` (a
    list of tensors -> their sums over the processes) adds the shares.
    `work` counts the first step's forward as render counts it."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in scene.items()}
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate)
    losses, first = [], None
    for step in range(steps):
        loss, grads = loss_and_grad(params, cfg, target, block_pixels, pixels,
                                    work if step == 0 else None)
        if reduce is not None:
            loss, *parts = reduce([loss, *grads.values()])
            grads = dict(zip(grads, parts))
        for k, p in params.items():
            p.grad = grads[k]
        opt.step()
        losses.append(float(loss))
        if first is None:
            first = {k: g.clone() for k, g in grads.items()}
    return losses, first, {k: v.detach().clone() for k, v in params.items()}


def norm(t) -> float:
    return math.sqrt(float(torch.sum(t.double() ** 2)))
