"""raytpu_torch — the Whitted ray tracer of raytpu, in PyTorch and CUDA.

The port of the JAX package `raytpu` (which stays as its reference) to
PyTorch with hand-written CUDA kernels for NVIDIA Hopper.  It imports torch
and never jax.

Every scene builder puts its scene on this process's card unless given a
device (device="cpu" for the CPU), and raises without a card; every path
then runs where the scene lies.

Public surface:
    raytpu_torch.config     RenderConfig, BENCH_CONFIGS
    raytpu_torch.device     the default device: this process's card
    raytpu_torch.scene      Scene / Spheres / Lights / Medium dataclasses, builders
                            (the SPD sphereflake among them)
    raytpu_torch.scene_io   JSON scene files (raytpu's schema)
    raytpu_torch.image      tone mapping + PPM I/O (golden-image contract)
    raytpu_torch.trace      eager bounce-tree tracer + camera model
    raytpu_torch.camera     posed cameras (View, turntable) for fits from
                            several views of a world-space scene
    raytpu_torch.kernels    the CUDA kernels (dense forward and backward, the
                            wavefront's level and compaction and their
                            backwards), their plain versions, the autograd
                            Functions pairing them, the wavefront tracer,
                            raytpu's tiled pixel layout and its tile
                            culling (kernels.culling)
    raytpu_torch.render     backend choice, one-device and sharded render
                            with the wavefront's capacity ladder, CUDA-event
                            timing
    raytpu_torch.grad       losses, scene gradient (one device or sharded,
                            or in the tiled layout: pack_target,
                            loss_and_grad_packed), fit, finite differences
    raytpu_torch.parallel   the pixel mesh and its collectives on
                            torch.distributed
    raytpu_torch.oracle     the strict-semantics oracle (the reference's
                            quirks bug for bug) in tensors: the plain
                            version of the oracle kernel
    raytpu_torch.native     the oracle kernel on the card (render_native)
    raytpu_torch.utils      CUDA-event timer, profiler traces (profile_trace,
                            scoped), fit checkpoints, checked render
    raytpu_torch.cli        command-line driver
    raytpu_torch.examples   runnable examples (fit_scene, fit_golden_scene,
                            animate)
    raytpu_torch.tools      kernel and path A/B timing, the multiprocess demo
"""

from raytpu_torch.camera import View, scene_in_view, turntable
from raytpu_torch.config import BENCH_CONFIGS, RenderConfig
from raytpu_torch.grad import (exposure_image_loss, finite_difference_check,
                               fit_scene, image_loss, loss_and_grad,
                               loss_and_grad_packed, loss_and_grad_sharded,
                               loss_and_grad_wavefront, pack_target)
from raytpu_torch.image import max_colour_value, read_ppm, tone_map, write_ppm
from raytpu_torch.kernels.wavefront import (render_image_wavefront,
                                            render_pixels_wavefront)
from raytpu_torch.parallel import (gather_image, initialize_distributed,
                                   make_mesh)
from raytpu_torch.render import (DroppedRaysError, render_sharded, render_single,
                                 render_timed, resolve_backend)
from raytpu_torch.scene import (SPHEREFLAKE_VIEW, Lights, Medium, Scene, Spheres,
                                build_scene, default_scene, make_material,
                                random_scene, scene_from_leaves,
                                scene_from_numpy, scene_leaves, scene_to_numpy,
                                single_sphere_scene, sphereflake_scene)
from raytpu_torch.scene_io import load_scene, save_scene
from raytpu_torch.trace import camera_rays, render_image, render_pixels, trace_rays
from raytpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from raytpu_torch.utils.debug import checked_render

__version__ = "0.1.0"

__all__ = [
    "RenderConfig", "BENCH_CONFIGS",
    "Scene", "Spheres", "Lights", "Medium",
    "build_scene", "default_scene", "make_material", "random_scene",
    "sphereflake_scene", "SPHEREFLAKE_VIEW", "single_sphere_scene",
    "scene_from_numpy", "scene_to_numpy",
    "scene_leaves", "scene_from_leaves",
    "load_scene", "save_scene",
    "render_image", "render_pixels", "trace_rays", "camera_rays",
    "View", "turntable", "scene_in_view",
    "render_single", "render_sharded", "render_timed", "resolve_backend",
    "DroppedRaysError", "make_mesh", "initialize_distributed", "gather_image",
    "render_pixels_wavefront", "render_image_wavefront",
    "tone_map", "write_ppm", "read_ppm", "max_colour_value",
    "image_loss", "exposure_image_loss", "loss_and_grad",
    "loss_and_grad_packed", "pack_target", "loss_and_grad_wavefront",
    "loss_and_grad_sharded", "fit_scene",
    "finite_difference_check", "save_checkpoint", "load_checkpoint",
    "checked_render",
    "__version__",
]
