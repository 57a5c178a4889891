"""Timing and tracing (the counterpart of raytpu.utils.profiling):

  * Timer         — named sections between CUDA events recorded on the
                    current stream.
  * profile_trace — a torch.profiler trace of a block (CPU, and CUDA where
                    a card is present), written to a directory for
                    Perfetto or TensorBoard.
  * scoped        — a decorator naming a function's span in that trace.
"""

from __future__ import annotations

import contextlib
import functools

import torch


class Timer:
    """Accumulate named sections timed with CUDA event pairs.

    Each section records a start and an end event on the current stream of
    `device`; `summary()` synchronises once and returns the seconds of each
    section as lists, in the order they ran."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"Timer times CUDA work; got device {self.device}")
        self._events: dict[str, list] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        stream = torch.cuda.current_stream(self.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        try:
            yield
        finally:
            end.record(stream)
            self._events.setdefault(name, []).append((start, end))

    def summary(self) -> dict[str, list[float]]:
        torch.cuda.synchronize(self.device)
        return {name: [s.elapsed_time(e) / 1e3 for s, e in pairs]
                for name, pairs in self._events.items()}


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block with torch.profiler: CPU activity, and CUDA
    activity where a card is present.  On exit the trace is written into
    `log_dir` as a Chrome trace (*.pt.trace.json), which Perfetto opens and
    TensorBoard's profiler plugin reads.  Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def scoped(name: str):
    """Decorator: run the function inside torch.profiler.record_function
    (`name`), so its span carries that name in a profile_trace trace."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)

        return wrapper

    return deco
