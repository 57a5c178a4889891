"""The strict-semantics oracle on the card (the counterpart of
raytpu.native): a launch of the oracle kernels, csrc/oracle.cu.

raytpu.native builds native/rt_oracle.cpp with g++ and renders on the
host; the port's copy of that source is written for the card (a thread a
camera sample, then a thread a pixel adding its samples) and built
with nvcc (sm_90a, -fmad=false, IEEE division and sqrt) into
raytpu_torch/build/ at first use, by the machinery of the other kernels
(kernels.trace_cuda.CudaKernel).  Its plain version is
raytpu_torch.oracle.render_oracle, which it equals bit for bit at mask 0.

A CPU scene is refused: the kernel runs on a card, and the tensor oracle
renders on the CPU.  The golden-residual experiments' masks
(rt_oracle.cpp's g_fma_mask and g_approx_mask bit tables, repeated in
oracle.cu) are arguments of each call, not process-wide state.
"""

from __future__ import annotations

import ctypes

import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels.trace_cuda import CudaKernel, _check_scene, scene_tables

_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float

# spheres, n, lights, nl, bg, width, height, zoom, world_w, world_h, alias,
# cap, wide_fresnel, fma_mask, approx_mask, offset, count, samples, out,
# device, stream
ORACLE = CudaKernel(
    "oracle", "oracle.cu", "raytpu_oracle",
    [_p, _i, _p, _i, _p, _i, _i, _f, _f, _f, _i, _i, _i, _i, _i, _ll, _ll, _p,
     _p, _i, _p],
    entries={"raytpu_oracle_stack_bytes": [_i], "raytpu_oracle_stack_base": [],
             "raytpu_oracle_stack_per_level": []})

FMA_BITS = 5     # fma_mask bits 0-4
APPROX_BITS = 6  # approx_mask bits 0-5


def render_native(scene, cfg: RenderConfig, cap: int = 5,
                  fresnel_double: bool = False, offset: int = 0,
                  count: int | None = None, fma_mask: int = 0,
                  approx_mask: int = 0) -> torch.Tensor:
    """Strict-semantics render of a CUDA scene through the oracle kernel.

    Defaults (cap=5, float Fresnel) model the configuration that reproduces
    the reference's GPU golden.  Returns the (H, W, 3) frame, or (count, 3)
    for the pixels offset .. offset+count-1 when offset or count is given,
    float32 on the scene's card.  `fma_mask` and `approx_mask` select the
    golden-residual experiments (0: the strict semantics).  Raises on a CPU
    scene (render there with raytpu_torch.oracle.render_oracle) and on what
    the kernel does not take."""
    device = scene.device
    if device.type != "cuda":
        raise ValueError(
            f"render_native launches the oracle kernel on a CUDA scene, got "
            f"{device}; on the CPU use raytpu_torch.oracle.render_oracle")
    if cap < 1:
        raise ValueError(f"the oracle takes a stack capacity >= 1, got {cap}")
    if not 0 <= fma_mask < 1 << FMA_BITS or not 0 <= approx_mask < 1 << APPROX_BITS:
        raise ValueError(f"fma_mask takes bits 0-{FMA_BITS - 1} and approx_mask "
                         f"bits 0-{APPROX_BITS - 1}, got {fma_mask} and "
                         f"{approx_mask}")
    full = count is None and offset == 0
    if count is None:
        count = cfg.num_pixels - offset
    if offset < 0 or count < 0 or offset + count > cfg.num_pixels:
        raise ValueError(f"pixels {offset}..{offset + count} are not in the "
                         f"frame's 0..{cfg.num_pixels}")
    _check_scene(scene, device, bounded=False)
    spheres, lights, bg = scene_tables(scene)
    out = torch.empty((count, 3), dtype=torch.float32, device=device)
    samples = torch.empty((count * cfg.samples_per_pixel, 3),
                          dtype=torch.float32, device=device)
    err = ORACLE.function()(
        spheres.data_ptr(), scene.spheres.count, lights.data_ptr(),
        scene.lights.count, bg.data_ptr(), cfg.width, cfg.height, cfg.zoom,
        cfg.image_world_width, cfg.image_world_height, cfg.alias_factor, cap,
        int(fresnel_double), fma_mask, approx_mask, offset, count,
        samples.data_ptr(), out.data_ptr(), device.index or 0,
        torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"raytpu_oracle launch failed at cap {cap}: CUDA "
                           f"error {err} (a stack of "
                           f"{ORACLE.function('raytpu_oracle_stack_bytes')(cap)} "
                           f"bytes a thread)")
    ORACLE.launches += 1
    return out.reshape(cfg.height, cfg.width, 3) if full else out
