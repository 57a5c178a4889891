"""The eager tracer: camera model, supersampling, and the fixed-depth
bounce tree (the counterpart of raytpu.trace).

Every recursion level is one batch over all rays of the level, doubling in
width (refraction child + reflection child per hit).  The recursion is
affine: every node's matte or miss emission adds linearly into its pixel,
so the tree is summed level by level.  This is the port's CPU path and its
reference for the CUDA kernel on the card.

Camera model: raytrace_kernel.cl:908-968.  Pixel (ix, iy) maps to world
position ((ix - W/2)*xstep, (H/2 - iy)*ystep) on a 16x12 image plane;
supersample (i, j) adds (j*sub*aspect on x, i*sub on y) where
sub = xstep/aliasFactor — the reference's positive-corner-biased pattern.
The arithmetic is float32 throughout, as in raytpu.trace.

A `view` (camera.View) poses the camera in a world-space scene: the rays
leave its eye along R^T d (camera.posed_rays); without one (None) the
camera is the reference's, at the origin.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from raytpu_torch.camera import posed_rays
from raytpu_torch.config import RenderConfig
from raytpu_torch.ops.geometry import closest_hit, normalize
from raytpu_torch.ops.shading import is_significant, matte_light_sum, reflect, refract
from raytpu_torch.device import resolve_device


class CameraConstants(NamedTuple):
    """The per-frame camera scalars, each a float32 value."""

    xstep: float
    ystep: float
    aspect: float
    sub: float
    half_w: float
    half_h: float
    zoom: float
    weight: float  # 1 / alias^2


@functools.lru_cache(maxsize=64)
def camera_constants(cfg: RenderConfig) -> CameraConstants:
    """The camera scalars rounded in float32 as raytpu.trace computes them
    (xstep = f32(16) / f32(W), ...); the CUDA kernel takes the same values.
    A pure function of the frozen config, so computed once per config:
    every kernel launch reads it."""
    f32 = np.float32
    w, h = f32(cfg.width), f32(cfg.height)
    xstep = f32(cfg.image_world_width) / w
    return CameraConstants(*(float(v) for v in (
        xstep, f32(cfg.image_world_height) / h,
        f32(cfg.image_world_width) / f32(cfg.image_world_height),
        xstep / f32(cfg.alias_factor), w * f32(0.5), h * f32(0.5),
        f32(cfg.zoom), f32(1.0 / cfg.samples_per_pixel))))


def camera_rays(cfg: RenderConfig, sample_i: int, sample_j: int, gid=None,
                device=None, view=None):
    """Unit directions (len(gid), 3) of supersample (i, j) for the pixels
    `gid`, on gid's device; without `gid`, all H*W pixels on `device`,
    which defaults to this process's card (device.local_device) and
    raises without one: pass device="cpu" for the CPU.  With a `view`,
    (origins, directions) of the posed rays (camera.posed_rays)."""
    if gid is None:
        gid = torch.arange(cfg.num_pixels, dtype=torch.int64,
                           device=resolve_device(device))
    c = camera_constants(cfg)
    ix = (gid % cfg.width).to(torch.float32)
    iy = (gid // cfg.width).to(torch.float32)
    px = (ix - c.half_w) * c.xstep
    py = (c.half_h - iy) * c.ystep

    # Python floats holding float32 values: each op rounds in float32.
    x = (px + float(np.float32(sample_j) * np.float32(c.sub))) * c.aspect
    y = py + float(np.float32(sample_i) * np.float32(c.sub))
    z = torch.full_like(x, c.zoom)
    d = normalize(torch.stack([x, y, z], dim=-1))
    return d if view is None else posed_rays(view, d)


def _gather_medium(spheres, bg, index):
    """Medium fields for rays whose next medium is sphere `index` (or the
    background where index == -1) — calculateRefraction's targetMaterial
    lookup (raytracer.h:699-707)."""
    safe = torch.clamp(index, min=0)
    inside = index >= 0
    matte = torch.where(inside[..., None], spheres.matte[safe], bg.matte)
    ior = torch.where(inside, spheres.ior[safe], bg.ior)
    opacity = torch.where(inside, spheres.opacity[safe], bg.opacity)
    return matte, ior, opacity


def _trace_level(scene, origin, direction, intensity, med_matte, med_ior,
                 med_opacity, spawn: bool, medium_idx=None):
    """One bounce level: emissions for every ray in the batch, plus (if
    `spawn`) the refraction and reflection children, concatenated (2B rays).

    With `medium_idx` (the parents' medium as a sphere index, -1 for the
    background: the wavefront's compressed state), the children carry
    (origin, direction, intensity, medium index) instead of the three
    medium value fields: the refraction child the target's index, the
    reflection child its parent's.

    Emission (rayTrace stage 0, raytracer.h:454-550):
      miss  -> intensity * medium.matte, whatever the intensity's size
      hit   -> if the ray is significant and the material is not fully
               transparent: opacity * intensity * matte * sum-over-lights.
    Children (raytracer.h:494-536 and :552-615) exist only when
    transparency > 0: the refracted child carries transparency*(1-R)*I into
    the refraction target's medium; the reflected child carries
    ((transparency*R) + medium.opacity*gloss)*I — the reference scales the
    hit object's gloss by the CONTAINING medium's opacity — gated by its own
    significance test, in the parent's medium.
    """
    spheres, lights, bg = scene.spheres, scene.lights, scene.bg
    hit = closest_hit(origin, direction, spheres)
    sig = is_significant(intensity)
    live = hit.found & sig
    zero = torch.zeros_like(intensity)

    emission = torch.where(hit.found[..., None], zero, intensity * med_matte)

    mat_matte = spheres.matte[hit.index]
    mat_gloss = spheres.gloss[hit.index]
    opacity = spheres.opacity[hit.index]
    transparency = 1.0 - opacity

    light_sum = matte_light_sum(hit.point, hit.normal, spheres, lights)
    matte_gate = (live & (opacity > 0))[..., None]
    emission = emission + torch.where(
        matte_gate, opacity[..., None] * intensity * mat_matte * light_sum, zero)

    if not spawn:
        return emission, None

    spawn_mask = live & (transparency > 0)

    r_origin, r_dir, refl_factor, target_idx = refract(
        hit.point, hit.normal, direction, med_ior, spheres, bg)
    r_intensity = torch.where(
        spawn_mask[..., None],
        (transparency * (1.0 - refl_factor))[..., None] * intensity, zero)
    t_matte, t_ior, t_opacity = _gather_medium(spheres, bg, target_idx)

    refl_col = ((transparency * refl_factor)[..., None]
                + med_opacity[..., None] * mat_gloss) * intensity
    refl_gate = spawn_mask & is_significant(refl_col)
    g_origin, g_dir = reflect(direction, hit.normal, hit.point)
    g_intensity = torch.where(refl_gate[..., None], refl_col, zero)

    if medium_idx is not None:
        return emission, (torch.cat([r_origin, g_origin]),
                          torch.cat([r_dir, g_dir]),
                          torch.cat([r_intensity, g_intensity]),
                          torch.cat([target_idx.to(medium_idx.dtype), medium_idx]))
    children = (
        torch.cat([r_origin, g_origin]),
        torch.cat([r_dir, g_dir]),
        torch.cat([r_intensity, g_intensity]),
        torch.cat([t_matte, med_matte]),
        torch.cat([t_ior, med_ior]),
        torch.cat([t_opacity, med_opacity]),
    )
    return emission, children


def trace_rays(scene, origin, direction, intensity, max_depth: int,
               observe=None):
    """Trace a flat batch of rays to `max_depth` bounce levels; returns the
    per-ray colour (B, 3).  Rays start in the scene's background medium.
    `observe`, where given, is called after each level with (level,
    emission, children), children None at the last level."""
    b = direction.shape[0]
    origin = torch.broadcast_to(origin, direction.shape).to(torch.float32)
    med_matte = torch.broadcast_to(scene.bg.matte, (b, 3))
    med_ior = torch.broadcast_to(scene.bg.ior, (b,))
    med_opacity = torch.broadcast_to(scene.bg.opacity, (b,))

    total = torch.zeros((b, 3), dtype=torch.float32, device=direction.device)
    state = (origin, direction, intensity, med_matte, med_ior, med_opacity)
    for level in range(max_depth + 1):
        emission, children = _trace_level(scene, *state, spawn=level < max_depth)
        if observe is not None:
            observe(level, emission, children)
        # Level d holds 2^d contiguous copies of the B-ray batch.
        total = total + torch.sum(emission.reshape(-1, b, 3), dim=0)
        state = children
    return total


def _render_gid_chunk(scene, gid, cfg: RenderConfig, observe=None, view=None):
    """Render one chunk of pixel ids: every supersample pattern through the
    full bounce tree, averaged with the 1/aliasFactor^2 weight
    (raytrace_kernel.cl:945-968).  `observe` as in trace_rays; `view` as
    in camera_rays."""
    acc = torch.zeros((gid.shape[0], 3), dtype=torch.float32, device=gid.device)
    origin = torch.zeros((1, 3), dtype=torch.float32, device=gid.device)
    weight = camera_constants(cfg).weight
    for i in range(cfg.alias_factor):
        for j in range(cfg.alias_factor):
            if view is None:
                d = camera_rays(cfg, i, j, gid)
            else:
                origin, d = camera_rays(cfg, i, j, gid, view=view)
            colour = trace_rays(scene, origin, d, torch.ones_like(d),
                                cfg.max_depth, observe)
            acc = acc + weight * colour
    return acc


def render_pixels(scene, cfg: RenderConfig, gid, observe=None, view=None):
    """Render a flat block of pixel ids -> (B, 3) linear colour, in chunks
    of cfg.chunk_pixels so the 2^depth ray tree's memory stays bounded.
    `observe` as in trace_rays, for every chunk and supersample; `view`
    (a camera.View) poses the camera, None the reference's."""
    if gid.shape[0] == 0:
        return torch.zeros((0, 3), dtype=torch.float32, device=gid.device)
    return torch.cat([_render_gid_chunk(scene, g, cfg, observe, view)
                      for g in torch.split(gid, cfg.chunk_pixels)])


def render_image(scene, cfg: RenderConfig, observe=None, view=None):
    """Render the full frame on the scene's device: (H, W, 3) float32.
    `observe` and `view` as in render_pixels."""
    gid = torch.arange(cfg.num_pixels, dtype=torch.int64, device=scene.device)
    return render_pixels(scene, cfg, gid, observe, view).reshape(
        cfg.height, cfg.width, 3)
