"""Hand-written CUDA kernels for the hot path, each beside its plain
PyTorch version."""

from raytpu_torch.kernels.trace_cuda import (
    TRACE_FWD,
    render_image_cuda,
    render_pixels_cuda,
    render_pixels_torch,
)

__all__ = [
    "TRACE_FWD",
    "render_image_cuda",
    "render_pixels_cuda",
    "render_pixels_torch",
]
