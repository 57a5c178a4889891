"""Timing and tracing (the counterpart of raytpu.utils.profiling):

  * Timer         — named sections: by the host clock on the CPU, between
                    CUDA events recorded on the current stream on a card.
  * profile_trace — a torch.profiler trace of a block (CPU, and CUDA where
                    a card is present), written to a directory for
                    Perfetto or TensorBoard.
  * scoped        — a decorator naming a function's span in that trace.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time

import torch


def _cuda_devices(value):
    """The CUDA devices of the tensors in `value` (a tensor, or tensors in
    tuples, lists, dicts and dataclasses such as a Scene)."""
    if isinstance(value, torch.Tensor):
        return {value.device} if value.is_cuda else set()
    if isinstance(value, (tuple, list)):
        items = value
    elif isinstance(value, dict):
        items = value.values()
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        items = vars(value).values()
    else:
        return set()
    return set().union(*map(_cuda_devices, items))


class Timer:
    """Accumulate named sections, as raytpu's Timer does.

    Without a device, or on the CPU, each section is timed by the host
    clock, and a CUDA tensor handed to it (`result=`, or box["value"] set
    inside the block) is waited for first, so its device work is inside
    the section.  On a CUDA device each section records a start and an end
    event on the device's current stream: the device time between them,
    with no synchronisation until the times are read.

    `summary()` returns raytpu's form, {name: total seconds}; `times()`
    returns each section's seconds as a list, in the order they ran."""

    def __init__(self, device=None):
        self.device = torch.device("cpu" if device is None else device)
        self._spans: dict[str, list] = {}

    @contextlib.contextmanager
    def section(self, name: str, result=None):
        box = {}
        spans = self._spans.setdefault(name, [])
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(stream)
            try:
                yield box
            finally:
                end.record(stream)
                spans.append((start, end))
            return
        t0 = time.perf_counter()
        try:
            yield box
        finally:
            for device in _cuda_devices(box.get("value", result)):
                torch.cuda.synchronize(device)
            spans.append(time.perf_counter() - t0)

    def times(self) -> dict[str, list[float]]:
        """Each section's seconds, in the order they ran (on a card this
        waits for the device once)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            return {name: [s.elapsed_time(e) / 1e3 for s, e in spans]
                    for name, spans in self._spans.items()}
        return {name: list(spans) for name, spans in self._spans.items()}

    def summary(self) -> dict[str, float]:
        """{name: the seconds of its sections summed}."""
        return {name: sum(ts) for name, ts in self.times().items()}


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
