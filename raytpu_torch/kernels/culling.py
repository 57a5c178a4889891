"""Per-tile conservative sphere culling: the building blocks of
raytpu.kernels.culling, function for function, in torch.

As in raytpu, nothing wires them into a render: raytpu measured them and
left them out (its culling.py:1-14: interval beam tests cull only
block-ordered camera tiles, and after one bounce the tiles' direction
spread defeats them).  The port's per-ray culling is the BVH its level
kernel walks (csrc/bvh.cuh, kernels/bvh.py).  These are plain tensor
functions on their inputs' device; the float32 interval arithmetic is
raytpu's op for op, so the masks equal raytpu's bit for bit.

  * `bin_key` — a per-ray spatial sort key (origin cell | direction
    octant);
  * `tile_bounds` — per-tile interval bounds of ray origin/direction;
  * `beam_live_mask` — a conservative (tiles, N) liveness test: sphere s is
    dead for a tile only when no ray with origin in the tile's origin box
    and direction in its direction box can intersect s.  With a = |d|^2 >
    0 and every origin strictly outside the sphere (c_lo > 0), both roots
    of the reference's quadratic (raySphere, raytracer.h:96-118) share
    c/a's sign, so a forward hit needs b < 0 and a real radicand: dead iff
    c_lo > 0 and (b_lo >= 0 or max b^2 < 4 a_lo c_lo).  The t < 1000
    render-distance cap is ignored (conservative);
  * `segment_hull_live_mask` — the same for shadow segments to a light;
  * `pack_tile_scene` — per-tile scene tables with the live spheres first
    in their own order (the running minimum's lowest-index tie-break holds
    on the packed prefix) and a per-tile live count.
"""

from __future__ import annotations

import numpy as np
import torch

# Spatial grid for the sort key: 8x8x8 cells over the scene's sphere bounds.
CELL_BITS = 3  # per axis
N_CELLS = 1 << (3 * CELL_BITS)

# Sort-key layout (int32): [cell:9][octant:3].
_OCTANT_BITS = 3


def direction_octant(dx, dy, dz):
    """Sign octant of a direction, 0..7 (int32)."""
    return ((dx < 0).to(torch.int32) + 2 * (dy < 0).to(torch.int32)
            + 4 * (dz < 0).to(torch.int32))


def scene_bounds(sphere_pos, sphere_rad):
    """Static (lo, span) numpy float32 bounds of the scene's spheres, on
    the host; span is at least 1e-3 a side."""
    if isinstance(sphere_pos, torch.Tensor):
        sphere_pos, sphere_rad = sphere_pos.cpu().numpy(), sphere_rad.cpu().numpy()
    pos = np.asarray(sphere_pos, np.float32)
    rad = np.asarray(sphere_rad, np.float32)[:, None]
    lo = (pos - rad).min(axis=0)
    hi = (pos + rad).max(axis=0)
    span = np.maximum(hi - lo, 1e-3)
    return lo.astype(np.float32), span.astype(np.float32)


def spatial_cell(x, y, z, lo, span):
    """Row-major cell id over an 8^3 grid spanning the scene bounds (lo,
    span from scene_bounds); points outside clamp to the boundary cells."""
    n = 1 << CELL_BITS

    def axis(v, i):
        # A divisor on v's device: CUDA divides by a host scalar as a
        # product with its reciprocal, which rounds otherwise.
        d = torch.tensor(span[i], dtype=torch.float32, device=v.device)
        return torch.clamp(((v - float(lo[i])) / d * n).to(torch.int32),
                           0, n - 1)

    return (axis(x, 0) << (2 * CELL_BITS)) | (axis(y, 1) << CELL_BITS) | axis(z, 2)


def bin_key(ox, oy, oz, dx, dy, dz, lo, span):
    """Spatial sort key: (origin cell << 3) | direction octant, 12 bits."""
    cell = spatial_cell(ox, oy, oz, lo, span)
    return (cell << _OCTANT_BITS) | direction_octant(dx, dy, dz)


def tile_bounds(fields, tile_size: int):
    """Per-tile (min, max) of each flat (R,) field; R % tile_size == 0.

    Returns a list of (lo, hi) pairs of shape (tiles,)."""
    out = []
    for fld in fields:
        t = fld.reshape(-1, tile_size)
        out.append((t.amin(dim=1), t.amax(dim=1)))
    return out


def _interval_prod(alo, ahi, blo, bhi):
    """Interval product [alo,ahi] * [blo,bhi]."""
    c0, c1, c2, c3 = alo * blo, alo * bhi, ahi * blo, ahi * bhi
    lo = torch.minimum(torch.minimum(c0, c1), torch.minimum(c2, c3))
    hi = torch.maximum(torch.maximum(c0, c1), torch.maximum(c2, c3))
    return lo, hi


def _interval_sq(lo, hi):
    """Interval square: [0 if straddles else min^2, max^2]."""
    m = torch.maximum(torch.abs(lo), torch.abs(hi))
    straddles = (lo <= 0) & (hi >= 0)
    lo2 = torch.where(straddles, torch.zeros_like(lo),
                      torch.minimum(lo * lo, hi * hi))
    return lo2, m * m


def _f32(v) -> float:
    """A Python float holding v rounded to float32."""
    return float(np.float32(v))


def beam_live_mask(bounds, sphere_pos, sphere_rad, inflate=0.0):
    """Conservative liveness of each sphere for each ray tile.

    bounds: [(o_lo,o_hi) x3, (d_lo,d_hi) x3] per-tile interval tensors
    (tiles,), as from `tile_bounds` over (ox,oy,oz,dx,dy,dz).
    sphere_pos (N,3), sphere_rad (N,).  `inflate` grows radii (to cover
    the containment probe's +-0.01*d offset and the 1e-6 epsilon).

    Returns (tiles, N) bool: True means "some ray in this tile may hit".
    """
    (oxl, oxh), (oyl, oyh), (ozl, ozh), \
        (dxl, dxh), (dyl, dyh), (dzl, dzh) = bounds
    sx, sy, sz = (sphere_pos[:, 0][None, :], sphere_pos[:, 1][None, :],
                  sphere_pos[:, 2][None, :])
    rad = sphere_rad[None, :] + _f32(inflate)

    def col(v):  # (tiles, 1)
        return v[:, None]

    # e = o - s per component, interval
    exl, exh = col(oxl) - sx, col(oxh) - sx
    eyl, eyh = col(oyl) - sy, col(oyh) - sy
    ezl, ezh = col(ozl) - sz, col(ozh) - sz

    # c = |e|^2 - r^2
    ex2l, _ = _interval_sq(exl, exh)
    ey2l, _ = _interval_sq(eyl, eyh)
    ez2l, _ = _interval_sq(ezl, ezh)
    c_lo = ex2l + ey2l + ez2l - rad * rad

    # a = |d|^2
    dx2l, _ = _interval_sq(col(dxl), col(dxh))
    dy2l, _ = _interval_sq(col(dyl), col(dyh))
    dz2l, _ = _interval_sq(col(dzl), col(dzh))
    a_lo = dx2l + dy2l + dz2l

    # b = 2 sum d_i e_i
    bxl, bxh = _interval_prod(col(dxl), col(dxh), exl, exh)
    byl, byh = _interval_prod(col(dyl), col(dyh), eyl, eyh)
    bzl, bzh = _interval_prod(col(dzl), col(dzh), ezl, ezh)
    b_lo = 2.0 * (bxl + byl + bzl)
    b_hi = 2.0 * (bxh + byh + bzh)
    _, b2_hi = _interval_sq(b_lo, b_hi)

    outside = c_lo > 0
    never_toward = b_lo >= 0
    never_real = b2_hi < 4.0 * a_lo * c_lo
    dead = outside & (never_toward | never_real)
    return ~dead


def segment_hull_live_mask(hit_bounds, light_pos, sphere_pos, sphere_rad,
                           inflate=0.0):
    """Conservative occluder liveness per (tile, sphere) for one light:
    True unless no segment from the tile's hit-point box to the light can
    pass through the sphere (the shadow test, hasClearLineOfSight,
    raytracer.h:272-309).  Per component the segment's coordinate lies in
    the convex span of the box and the light's coordinate, and the
    distance of that box to the centre is bounded from below by interval
    arithmetic.

    hit_bounds: [(lo,hi) x3] per-tile tensors for hit x/y/z.
    light_pos: (3,).  Returns (tiles, N) bool.
    """
    (hxl, hxh), (hyl, hyh), (hzl, hzh) = hit_bounds
    sx, sy, sz = (sphere_pos[:, 0][None, :], sphere_pos[:, 1][None, :],
                  sphere_pos[:, 2][None, :])
    rad = sphere_rad[None, :] + _f32(inflate)

    def col(v):
        return v[:, None]

    gxl = torch.minimum(col(hxl), light_pos[0]) - sx
    gxh = torch.maximum(col(hxh), light_pos[0]) - sx
    gyl = torch.minimum(col(hyl), light_pos[1]) - sy
    gyh = torch.maximum(col(hyh), light_pos[1]) - sy
    gzl = torch.minimum(col(hzl), light_pos[2]) - sz
    gzh = torch.maximum(col(hzh), light_pos[2]) - sz
    dx2, _ = _interval_sq(gxl, gxh)
    dy2, _ = _interval_sq(gyl, gyh)
    dz2, _ = _interval_sq(gzl, gzh)
    dist2_lo = dx2 + dy2 + dz2
    return dist2_lo <= rad * rad


def pack_tile_scene(live, scene_tbl):
    """Pack live spheres first, per tile.

    live: (tiles, N) bool; scene_tbl: any (rows, N) table, such as
    trace_cuda.scene_tables' sphere table.

    Returns (tiles_tbl (tiles, rows, N), counts (tiles,) int32).  The
    permutation is stable: live spheres keep ascending sphere order, so
    running-min tie-breaks match the unculled loop exactly; dead spheres
    follow, also in order."""
    order = torch.argsort((~live).to(torch.uint8), dim=1, stable=True)
    counts = live.sum(dim=1).to(torch.int32)
    # tiles_tbl[t, :, i] = scene_tbl[:, order[t, i]]
    return scene_tbl[:, order].permute(1, 0, 2), counts
