"""Hand-written CUDA kernels for the hot path, each beside its plain
PyTorch version."""

from raytpu_torch.kernels.trace_cuda import (
    TRACE_BWD,
    TRACE_FWD,
    RenderPixelsFn,
    grad_pixels_cuda,
    grad_pixels_torch,
    render_image_cuda,
    render_pixels_cuda,
    render_pixels_cuda_ad,
    render_pixels_torch,
)

__all__ = [
    "TRACE_BWD",
    "TRACE_FWD",
    "RenderPixelsFn",
    "grad_pixels_cuda",
    "grad_pixels_torch",
    "render_image_cuda",
    "render_pixels_cuda",
    "render_pixels_cuda_ad",
    "render_pixels_torch",
]
