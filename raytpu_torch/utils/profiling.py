"""Timing and tracing (the counterpart of raytpu.utils.profiling):

  * Timer         — named sections: by the host clock on the CPU, between
                    CUDA events recorded on the current stream on a card.
  * profile_trace — a torch.profiler trace of a block (CPU, and CUDA where
                    a card is present), written to a directory for
                    Perfetto or TensorBoard.
  * span          — a named span of the program, as a context manager or
                    a decorator; scoped(name) is span(name) as a decorator.
  * count         — add to a named counter; recording says whether one
                    would be kept.
  * spans, counters, reset — the recorder's read-out.

The recorder is gated on the profiler: while a torch profiler records
(torch.autograd.profiler._is_profiler_enabled, which the profiler sets
when it starts and clears when it stops), a span enters
torch.profiler.record_function(name), so that it lies in the profiler's
trace beside the kernels it launched, and adds its count, its total host
nanoseconds and its self nanoseconds (the total less its child spans') to
a table by name; `count` adds to its counter.  Otherwise a span or a count
reads that one flag and does nothing else.  Each thread keeps its own
stack of open spans: the autograd engine runs a CUDA backward on a thread
of its own, and a span there is nobody's child on the main thread.

A counter takes a host int or a 0-d device tensor (a count the device
already holds, such as the compaction's n_kept): the tensor is kept, and
the counter sums its tensors when read, so counting costs the device no
kernel and the host no synchronise.  The one record kept with the profiler
off is the kernels' load (`kernel.load_s`, `kernel.builds`), a cold path
that runs before any trace: counters() reports it, and every registered
kernel's `launches`, beside the recorded counts.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import threading
import time

import torch

# The module whose _is_profiler_enabled every span and count reads first.
_PROFILER = torch.autograd.profiler
# A counter folds its device tensors into one a device when it holds
# this many (two small kernels), so that a long trace holds bounded memory.
HELD_TENSORS = 4096


class _Local(threading.local):
    def __init__(self):
        self.stack = []  # this thread's open spans, innermost last


_lock = threading.Lock()
_local = _Local()
_spans: dict[str, list] = {}   # name -> [count, total ns, self ns]
_counts: dict[str, list] = {}  # name -> [host sum, [0-d device tensors]]
_kernels: list = []            # register_kernel's, for their launches
_load = {"kernel.load_s": 0.0, "kernel.builds": 0}


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


class span:
    """A named span: `with span(name): ...`, or `@span(name)` on a
    function, whose every call is then the span.

    While a torch profiler records, the block runs inside
    torch.profiler.record_function(name) and its count, total and self
    host nanoseconds go to the recorder (spans()); self time is the total
    less that of the spans opened inside it on the same thread.  Otherwise
    it reads the profiler's flag and nothing else."""

    __slots__ = ("name", "_fn", "_t0", "_child")

    def __init__(self, name: str):
        self.name = name
        self._fn = None

    def __enter__(self):
        if _PROFILER._is_profiler_enabled:
            self._start()
        return self

    def __exit__(self, *exc):
        if self._fn is not None:
            self._stop()
        return False

    def _start(self):
        self._t0 = time.perf_counter_ns()
        self._child = 0
        self._fn = torch.profiler.record_function(self.name)
        self._fn.__enter__()
        _local.stack.append(self)

    def _stop(self):
        stack = _local.stack
        stack.pop()
        fn, self._fn = self._fn, None
        fn.__exit__(None, None, None)
        ns = time.perf_counter_ns() - self._t0
        if stack:
            stack[-1]._child += ns
        with _lock:
            rec = _spans.setdefault(self.name, [0, 0, 0])
            rec[0] += 1
            rec[1] += ns
            rec[2] += ns - self._child

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not _PROFILER._is_profiler_enabled:
                return fn(*args, **kwargs)
            with span(name):
                return fn(*args, **kwargs)

        return wrapper


def scoped(name: str):
    """Decorator: every call of the function is span(name), which names it
    in a profile_trace trace and, while the profiler records, in
    spans()."""
    return span(name)


def _fold(held: list) -> list:
    """The 0-d tensors `held`, summed into one a device."""
    by_device: dict = {}
    for t in held:
        by_device.setdefault(t.device, []).append(t.to(torch.int64))
    return [torch.stack(ts).sum() for ts in by_device.values()]


def recording() -> bool:
    """Whether a torch profiler records: the flag every span and count
    reads first, for a count whose value costs work to find."""
    return _PROFILER._is_profiler_enabled


def count(name: str, n=1):
    """Add `n` (an int, or a 0-d integer tensor on any device) to the
    counter `name` while a torch profiler records; otherwise nothing."""
    if not _PROFILER._is_profiler_enabled:
        return
    with _lock:
        rec = _counts.setdefault(name, [0, []])
        if isinstance(n, torch.Tensor):
            rec[1].append(n.detach())
            if len(rec[1]) >= HELD_TENSORS:
                rec[1] = _fold(rec[1])
        else:
            rec[0] += int(n)


def register_kernel(kernel):
    """Report `kernel`'s launch count (its `name` and `launches`) in
    counters() as launches.<name>."""
    _kernels.append(kernel)


def kernel_loaded(seconds: float, built: bool):
    """Record a kernel library's load: its seconds (nvcc's included where
    it was `built`), whether or not a profiler records."""
    with _lock:
        _load["kernel.load_s"] += seconds
        _load["kernel.builds"] += int(built)


def spans() -> dict:
    """{name: {count, total_ns, self_ns}} of the spans recorded since the
    last reset()."""
    with _lock:
        return {name: {"count": c, "total_ns": t, "self_ns": s}
                for name, (c, t, s) in _spans.items()}


def counters() -> dict:
    """{name: value}: each counter recorded since the last reset() (its
    device tensors summed here, which waits for them), each registered
    kernel's launches as launches.<name>, and kernel.load_s and
    kernel.builds over the process."""
    with _lock:
        out = {name: host + sum(int(t) for t in _fold(held))
               for name, (host, held) in _counts.items()}
        out.update({f"launches.{k.name}": k.launches for k in _kernels})
        out.update(_load)
    return out


def reset():
    """Forget the recorded spans and counters (not the kernels' launches
    or load, which are the process's)."""
    with _lock:
        _spans.clear()
        _counts.clear()
