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
    raytpu_torch.kernels    the CUDA kernels (dense forward and backward, the
                            wavefront's level and compaction and their
                            backwards), their plain versions, the autograd
                            Functions pairing them, and the wavefront tracer
    raytpu_torch.render     backend choice, one-device render with the
                            wavefront's capacity ladder, CUDA-event timing
    raytpu_torch.grad       losses, scene gradient, fit, finite differences
    raytpu_torch.utils      CUDA-event timer, fit checkpoints
    raytpu_torch.cli        command-line driver
    raytpu_torch.examples   runnable examples (fit_scene)
"""

from raytpu_torch.config import BENCH_CONFIGS, RenderConfig
from raytpu_torch.grad import (exposure_image_loss, finite_difference_check,
                               fit_scene, image_loss, loss_and_grad,
                               loss_and_grad_wavefront)
from raytpu_torch.image import max_colour_value, read_ppm, tone_map, write_ppm
from raytpu_torch.kernels.wavefront import (render_image_wavefront,
                                            render_pixels_wavefront)
from raytpu_torch.render import (DroppedRaysError, render_single, render_timed,
                                 resolve_backend)
from raytpu_torch.scene import (Lights, Medium, Scene, Spheres, build_scene,
                                default_scene, make_material, random_scene,
                                scene_from_leaves, scene_from_numpy,
                                scene_leaves, scene_to_numpy,
                                single_sphere_scene)
from raytpu_torch.scene_io import load_scene, save_scene
from raytpu_torch.trace import camera_rays, render_image, render_pixels, trace_rays
from raytpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

__version__ = "0.1.0"

__all__ = [
    "RenderConfig", "BENCH_CONFIGS",
    "Scene", "Spheres", "Lights", "Medium",
    "build_scene", "default_scene", "make_material", "random_scene",
    "single_sphere_scene", "scene_from_numpy", "scene_to_numpy",
    "scene_leaves", "scene_from_leaves",
    "load_scene", "save_scene",
    "render_image", "render_pixels", "trace_rays", "camera_rays",
    "render_single", "render_timed", "resolve_backend", "DroppedRaysError",
    "render_pixels_wavefront", "render_image_wavefront",
    "tone_map", "write_ppm", "read_ppm", "max_colour_value",
    "image_loss", "exposure_image_loss", "loss_and_grad",
    "loss_and_grad_wavefront", "fit_scene",
    "finite_difference_check", "save_checkpoint", "load_checkpoint",
    "__version__",
]
