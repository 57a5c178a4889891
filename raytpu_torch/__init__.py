"""raytpu_torch — the Whitted ray tracer of raytpu, in PyTorch and CUDA.

The port of the JAX package `raytpu` (which stays as its reference) to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper.  It imports torch
and never jax.

Public surface:
    raytpu_torch.config     RenderConfig, BENCH_CONFIGS
    raytpu_torch.scene      Scene / Spheres / Lights / Medium dataclasses, builders
    raytpu_torch.scene_io   JSON scene files (raytpu's schema)
    raytpu_torch.image      tone mapping + PPM I/O (golden-image contract)
    raytpu_torch.trace      eager bounce-tree tracer + camera model
    raytpu_torch.kernels    the CUDA forward kernel and its plain version
    raytpu_torch.render     backend choice, one-device render, CUDA-event timing
    raytpu_torch.cli        command-line driver
"""

from raytpu_torch.config import BENCH_CONFIGS, RenderConfig
from raytpu_torch.image import max_colour_value, read_ppm, tone_map, write_ppm
from raytpu_torch.render import render_single, render_timed, resolve_backend
from raytpu_torch.scene import (Lights, Medium, Scene, Spheres, build_scene,
                                default_scene, make_material, random_scene,
                                scene_from_numpy, scene_to_numpy,
                                single_sphere_scene)
from raytpu_torch.scene_io import load_scene, save_scene
from raytpu_torch.trace import camera_rays, render_image, render_pixels, trace_rays

__version__ = "0.1.0"

__all__ = [
    "RenderConfig", "BENCH_CONFIGS",
    "Scene", "Spheres", "Lights", "Medium",
    "build_scene", "default_scene", "make_material", "random_scene",
    "single_sphere_scene", "scene_from_numpy", "scene_to_numpy",
    "load_scene", "save_scene",
    "render_image", "render_pixels", "trace_rays", "camera_rays",
    "render_single", "render_timed", "resolve_backend",
    "tone_map", "write_ppm", "read_ppm", "max_colour_value",
    "__version__",
]
