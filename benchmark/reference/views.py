"""The benchmark's plain reference for fits from several views: posed
cameras over a world-space scene, the V-view loss, its scene gradient and
the fit's Adam steps, in plain PyTorch over benchmark.reference.tracer's
bounce tree.

It imports nothing of the program.  A view is (rotation (3, 3), eye
(3,)), float32 tensors: the rotation's rows are the camera's right, up
and back in world coordinates, so that a world point p lies at R (p - eye)
in the camera's frame, where the camera sits at the origin and looks down
-z as main.cpp's camera does.  A camera sample of direction d in that
frame leaves the eye along R^T d, each component summed in a fixed order,
((R0j dx + R1j dy) + R2j dz), with no matrix product (so no TF32), as the
program states it.

The poses a traffic asks for are made here from the traffic's numbers
(look_at, turntable) in Python's float64, rounded once into float32; the
benchmark hands the same float32 poses to the program and to this
reference.

The loss of V views is the mean over every view's pixels,
sum over views and pixels of err^2 / (3 P V); each view's frame runs in
blocks of camera samples, each block's loss differentiated on its own.
TF32 is off while the reference computes (it makes no matrix product;
both switches are set all the same and put back after).
"""

from __future__ import annotations

import contextlib
import math

import torch

from benchmark.reference import tracer


# ------------------------------------------------------------------ poses

def _unit(v):
    n = math.sqrt((v[0] * v[0] + v[1] * v[1]) + v[2] * v[2])
    return [x / n for x in v]


def _cross(a, b):
    return [a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0]]


def _apply(m, v):
    return [(m[r][0] * v[0] + m[r][1] * v[1]) + m[r][2] * v[2] for r in range(3)]


def _turn(axis, angle: float):
    """The right-handed rotation by `angle` about the unit `axis`
    (Rodrigues), as rows of Python floats."""
    x, y, z = axis
    c, s = math.cos(angle), math.sin(angle)
    c1 = 1.0 - c
    return [[c + x * x * c1, x * y * c1 - z * s, x * z * c1 + y * s],
            [y * x * c1 + z * s, c + y * y * c1, y * z * c1 - x * s],
            [z * x * c1 - y * s, z * y * c1 + x * s, c + z * z * c1]]


def look_at(eye, at, up):
    """The camera at `eye` looking at `at`, `up` upward, in float64 (rows
    of Python floats, and the eye): back = (eye - at) / |eye - at|, right =
    up x back / |up x back|, up' = back x right."""
    eye, at, up = ([float(x) for x in v] for v in (eye, at, up))
    back = _unit([e - a for e, a in zip(eye, at)])
    right = _unit(_cross(up, back))
    return [right, _cross(back, right), back], eye


def turntable(rotation, eye, n: int, axis, pivot):
    """The n poses of a turntable, in float64: the camera (rotation, eye)
    turned about `axis` through `pivot` by k x 360/n degrees, k = 0 ..
    n-1; a camera turned by T has eye pivot + T (eye - pivot) and
    rotation R T^T."""
    axis = _unit([float(x) for x in axis])
    pivot = [float(x) for x in pivot]
    out = []
    for k in range(n):
        turn = _turn(axis, 2.0 * math.pi * k / n)
        rel = _apply(turn, [e - p for e, p in zip(eye, pivot)])
        out.append(([_apply(turn, row) for row in rotation],
                    [p + r for p, r in zip(pivot, rel)]))
    return out


def _float32(pose, device):
    rotation, eye = pose
    return (torch.tensor(rotation, dtype=torch.float64).to(torch.float32).to(device),
            torch.tensor(eye, dtype=torch.float64).to(torch.float32).to(device))


def traffic_views(spec: dict, device) -> list:
    """The float32 poses (rotation, eye) a traffic's "views" asks for, in
    the frame its configuration's scene lies in.  "turntable": the camera
    at "from" looking at "at", "up" upward, turned about "axis" through
    "pivot" by k x 360/"count" degrees, each pose rounded once; with
    "scene_frame" "view 0" the scene lies in that first camera's frame
    (as the SPD configuration moves it), so view 0 is the identity pose
    and the turn's axis and pivot are taken into that frame."""
    if spec["kind"] != "turntable":
        raise ValueError(f"unknown views kind {spec['kind']!r}")
    rot0, eye0 = look_at(spec["from"], spec["at"], spec["up"])
    if spec.get("scene_frame") == "view 0":
        base = ([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], [0.0] * 3)
        axis = _apply(rot0, [float(x) for x in spec["axis"]])
        pivot = _apply(rot0, [float(p) - e for p, e in zip(spec["pivot"], eye0)])
    else:
        base, axis, pivot = (rot0, eye0), spec["axis"], spec["pivot"]
    return [_float32(p, device)
            for p in turntable(*base, spec["count"], axis, pivot)]


def targets(render: dict, traffic: dict, seed: int, n_views: int, device):
    """The fit's (V, P, 3) linear targets: view k's "uniform" noise in [0,
    scale) drawn from a generator seeded from (seed, k)."""
    spec = traffic["target"]
    if spec["kind"] != "uniform":
        raise ValueError(f"unknown target kind {spec['kind']!r}")
    p = render["width"] * render["height"]
    out = []
    for k in range(n_views):
        g = torch.Generator(device=device)
        g.manual_seed((int(seed) * 1_000_003 + 1_000 + k) % (1 << 63))
        out.append(spec["scale"] * torch.rand((p, 3), generator=g, device=device))
    return torch.stack(out)


# ---------------------------------------------------------------- tracing

@contextlib.contextmanager
def no_tf32():
    """TF32 off for matrix products and convolutions, restored after."""
    was = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = was


def camera_samples(cfg: dict, first: int, count: int, view, device, dtype):
    """(origins, directions) of camera samples first .. first+count-1 of
    the posed camera `view`: the eye, and R^T d for tracer.camera_samples'
    directions d, rounded in `dtype`."""
    rotation, eye = (t.to(device=device, dtype=dtype) for t in view)
    d = tracer.camera_samples(cfg, first, count, device, dtype)
    world = torch.stack([(rotation[0, j] * d[:, 0] + rotation[1, j] * d[:, 1])
                         + rotation[2, j] * d[:, 2] for j in range(3)], dim=-1)
    return torch.zeros_like(d) + eye, world


def trace_samples(scene, cfg: dict, first: int, count: int, view, work=None):
    """tracer.trace_samples from the posed camera `view`: the linear
    colour (count, 3) of its camera samples first .. first+count-1."""
    dtype = scene["spheres.pos"].dtype
    device = scene["spheres.pos"].device
    origin, d = camera_samples(cfg, first, count, view, device, dtype)
    if work is not None:
        work["sample"] += count
    rays = (origin, d, torch.ones_like(d),
            torch.full((count,), -1, dtype=torch.int64, device=device),
            torch.arange(count, device=device))
    colour = torch.zeros((count, 3), dtype=dtype, device=device)
    for level in range(cfg["max_depth"] + 1):
        emission, children = tracer.trace_level(scene, rays,
                                                level < cfg["max_depth"], work)
        colour = colour.index_add(0, rays[4], emission)
        if children is None:
            break
        rays = children
    return colour


def render(scene, cfg: dict, view, block_pixels: int = 1 << 16, pixels=None):
    """The posed frame's linear colour, (P, 3) in pixel order, or that of
    the pixel range `pixels` = (first, count); no autograd."""
    spp = cfg["alias_factor"] ** 2
    weight = tracer.camera_constants(cfg, scene["spheres.pos"].dtype)["weight"]
    out = []
    with torch.no_grad(), no_tf32():
        for p, m in tracer._pixel_blocks(cfg, block_pixels, pixels):
            colour = trace_samples(scene, cfg, p * spp, m * spp, view)
            out.append(tracer.pixel_sum(colour, weight, m, spp))
    return torch.cat(out)


def loss_and_grad(scene, cfg: dict, targets, views, block_pixels: int = 1 << 16,
                  pixels=None):
    """The V-view loss, sum over views and pixels of (pixel - target)^2 /
    (3 P V), for targets (V, P, 3) and V views, and its gradient with
    respect to every leaf: (loss as a float64 tensor, {name: gradient}).
    `pixels` = (first, count) takes that pixel range's share of every
    view only (the terms are still divided by 3PV)."""
    spp = cfg["alias_factor"] ** 2
    scale = 3 * cfg["width"] * cfg["height"] * len(views)
    dtype = scene["spheres.pos"].dtype
    weight = tracer.camera_constants(cfg, dtype)["weight"]
    leaves = {k: v.detach().requires_grad_(True) for k, v in scene.items()}
    grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
    total = torch.zeros((), dtype=torch.float64, device=targets.device)
    with no_tf32():
        for view, target in zip(views, targets):
            for p, m in tracer._pixel_blocks(cfg, block_pixels, pixels):
                with torch.enable_grad():
                    colour = trace_samples(leaves, cfg, p * spp, m * spp, view)
                    pixel = tracer.pixel_sum(colour, weight, m, spp)
                    err = pixel - target[p:p + m].to(dtype)
                    loss = torch.sum(err * err) / scale
                    got = torch.autograd.grad(loss, list(leaves.values()),
                                              allow_unused=True)
                for (k, _), g in zip(leaves.items(), got):
                    if g is not None:
                        grads[k] += g
                total += loss.detach().double()
    return total, grads


def fit(scene, cfg: dict, targets, views, steps: int, learning_rate: float,
        block_pixels: int = 1 << 16, pixels=None, reduce=None):
    """`steps` steps of the V-view fit from `scene` with
    torch.optim.Adam(lr=learning_rate): (losses, the first step's gradient
    {name: tensor}, the leaves after the last step {name: tensor}).
    `pixels` and `reduce` as in tracer.fit: this process's share of every
    view, and the sum of the shares over the processes."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in scene.items()}
    opt = torch.optim.Adam(list(params.values()), lr=learning_rate)
    losses, first = [], None
    for _ in range(steps):
        loss, grads = loss_and_grad(params, cfg, targets, views, block_pixels,
                                    pixels)
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
