"""Timing on the card: named sections between CUDA events recorded on the
current stream (the counterpart of raytpu.utils.profiling.Timer)."""

from __future__ import annotations

import contextlib

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
