"""Utilities: CUDA-event timing."""

from raytpu_torch.utils.profiling import Timer

__all__ = ["Timer"]
