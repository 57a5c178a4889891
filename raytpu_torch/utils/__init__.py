"""Utilities: CUDA-event timing, fit checkpoints."""

from raytpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from raytpu_torch.utils.profiling import Timer

__all__ = ["Timer", "load_checkpoint", "save_checkpoint"]
