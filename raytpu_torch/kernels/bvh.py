"""The bounding-volume hierarchy (BVH) that the wavefront's level kernel
(K3, csrc/wf_level.cu) walks per ray, built on the device in plain torch.

It has no counterpart in raytpu: a TPU has no per-ray control flow, so
raytpu's level kernel tests every sphere for every ray (BASELINE.md:556-580
and raytpu/kernels/culling.py say why every tile-level culling it could
express was rejected).  The tree only selects which spheres a ray tests;
each test is the kernel's own, so the frame is bit-identical to the
brute-force loops' (csrc/bvh.cuh).

The layout csrc/bvh.cuh reads:

  * the spheres in Morton order of their centres (10 bits an axis over the
    centres' bounds, a stable argsort), cut into n_leaves = leaf_count(N)
    leaves, the largest power of two not above N, leaf j holding sorted
    positions [j N / n_leaves, (j + 1) N / n_leaves): one or two spheres,
    never none (of one, two and four a leaf, one was the fastest on config
    5 on an H100: PERF.md);
  * an implicit complete binary tree over the leaves: node 1 the root, node
    k's children 2k and 2k + 1, the leaves nodes n_leaves .. 2 n_leaves - 1;
  * `boxes` (6, 2 n_leaves) float32, rows lo xyz and hi xyz, column k node
    k's box (column 0 unused), filled bottom-up by pairwise min and max;
  * `order` (N,) int32, the sphere indices in leaf order.

Each sphere's box is its cube of half-width r, grown by

    PAD_REL (r + E) + PAD_ABS + (sqrt(r^2 + PAD_SQ E^2) - r),

E the scene's extent (the largest |coordinate| of a sphere's surface, a
light or a posed camera's eye), so that no sphere a float test accepts
lies outside its box.  The tests' inputs (ray origins, hit points,
centres, lights) lie in [-E, E]^3, so every distance D among them is at
most 2 sqrt(3) E.  A test rounds in two ways:

  * linearly, where a point or a parameter moves by a few ulps of D (the
    o - centre differences, the box faces, the slab parameters, the
    vertex of the shadow test, the container's radius + 1e-6): PAD_REL E,
    some 16,000 ulps of E, and PAD_ABS hold that;
  * in the quadratic: the closest-hit radicand b^2 - 4ac = 4a (r^2 - h^2),
    h the ray's distance from the centre, is computed with an error below
    ~18 u 4a (D^2 + r^2) <= 4a 234 u E^2 (u = 2^-24), and the shadow
    test's q(C) below ~6 u (4 D^2 + r^2) <= 294 u E^2.  So an accepted
    sphere has h^2 (or the segment's end at distance^2) below r^2 + 294 u
    E^2: it meets the ball of radius sqrt(r^2 + PAD_SQ E^2), PAD_SQ = 1024
    u, with a factor of 3 to spare.  That term grows as E^2 / r for small
    r, which a pad linear in E would not cover.

The build reads the tables detached and is never differentiated.  It
reads nothing back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from raytpu_torch.utils.profiling import scoped

MORTON_BITS = 10     # per axis
PAD_REL = 1e-3
PAD_ABS = 1e-4
PAD_SQ = 2.0 ** -14  # 1024 ulps of 1


@dataclass(frozen=True)
class Bvh:
    boxes: torch.Tensor   # (6, 2 * n_leaves) float32
    order: torch.Tensor   # (N,) int32
    n_leaves: int


def leaf_count(n_spheres: int) -> int:
    """The leaves for n >= 1 spheres: the largest power of two not above n,
    so that every leaf holds one or two spheres."""
    return 1 << (n_spheres.bit_length() - 1)


def _spread_bits(v):
    """The low 10 bits of v (int64) spread to every third bit."""
    v = (v | (v << 16)) & 0x030000FF
    v = (v | (v << 8)) & 0x0300F00F
    v = (v | (v << 4)) & 0x030C30C3
    v = (v | (v << 2)) & 0x09249249
    return v


def morton_codes(pos):
    """30-bit Morton codes of the (3, N) centres over their own bounds."""
    lo = pos.amin(dim=1, keepdim=True)
    span = (pos.amax(dim=1, keepdim=True) - lo).clamp_min(1e-30)
    top = (1 << MORTON_BITS) - 1
    q = torch.clamp((pos - lo) / span * top, 0, top).to(torch.int64)
    return (_spread_bits(q[0]) << 2) | (_spread_bits(q[1]) << 1) | _spread_bits(q[2])


def sphere_pad(rad, extent):
    """The pad of each sphere's box (see the head of the file); rad (N,)
    non-negative.  sqrt(r^2 + x) - r is taken as x / (sqrt(r^2 + x) + r),
    without cancellation."""
    quad = PAD_SQ * extent * extent
    return (PAD_REL * (rad + extent) + PAD_ABS
            + quad / (torch.sqrt(rad * rad + quad) + rad))


def sphere_boxes(spheres_tbl, lights_tbl, reach: float = 0.0):
    """(lo, hi), each (3, N): every sphere's box, inflated by sphere_pad.
    `reach`: the largest |coordinate| of a camera ray's origin (a posed
    camera's eye), which the extent covers too; the reference camera's
    origin, 0, needs none."""
    pos, rad = spheres_tbl[0:3], spheres_tbl[3].abs()
    extent = (pos.abs() + rad).amax()
    if lights_tbl.shape[1] > 0:
        extent = torch.maximum(extent, lights_tbl[0:3].abs().amax())
    if reach > 0:
        extent = torch.clamp(extent, min=float(reach))
    half = rad + sphere_pad(rad, extent)
    return pos - half, pos + half


@scoped("wf.bvh")
def build_bvh(spheres_tbl, lights_tbl, reach: float = 0.0) -> Bvh:
    """The tree over the scene of scene_tables (spheres (12, N), lights
    (6, L)), on the tables' device; `reach` as in sphere_boxes, for rays
    from posed cameras' eyes."""
    spheres_tbl, lights_tbl = spheres_tbl.detach(), lights_tbl.detach()
    lo, hi = sphere_boxes(spheres_tbl, lights_tbl, reach)
    order = torch.argsort(morton_codes(spheres_tbl[0:3]), stable=True)
    return tree_over(lo, hi, order)


def tree_over(lo, hi, order) -> Bvh:
    """The tree whose leaves hold the spheres in `order` (N,) int64, over
    the boxes (lo, hi), each (3, N)."""
    n = lo.shape[1]
    device = lo.device
    n_leaves = leaf_count(n)
    p = torch.arange(n, dtype=torch.int64, device=device)
    leaf = ((p + 1) * n_leaves - 1) // n  # leaf j starts at j * n // n_leaves
    boxes = torch.empty((6, 2 * n_leaves), dtype=torch.float32, device=device)
    boxes[:, 0] = 0.0
    at = leaf.expand(3, n)
    boxes[0:3, n_leaves:] = torch.full((3, n_leaves), float("inf"), device=device
                                       ).scatter_reduce(1, at, lo[:, order], "amin")
    boxes[3:6, n_leaves:] = torch.full((3, n_leaves), float("-inf"), device=device
                                       ).scatter_reduce(1, at, hi[:, order], "amax")
    width = n_leaves
    while width > 1:
        width //= 2
        kids = boxes[:, 2 * width:4 * width]
        boxes[0:3, width:2 * width] = torch.minimum(kids[0:3, 0::2], kids[0:3, 1::2])
        boxes[3:6, width:2 * width] = torch.maximum(kids[3:6, 0::2], kids[3:6, 1::2])
    return Bvh(boxes.contiguous(), order.to(torch.int32).contiguous(), n_leaves)
