"""Utilities: section timing (CUDA events on a card, the host clock on
the CPU), profiler traces and named spans, fit checkpoints, the checked
render."""

from raytpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from raytpu_torch.utils.debug import checked_render
from raytpu_torch.utils.profiling import Timer, profile_trace, scoped

__all__ = ["Timer", "checked_render", "load_checkpoint", "profile_trace",
           "save_checkpoint", "scoped"]
