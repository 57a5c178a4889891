"""The traced run's reduction: torch.profiler's events over the traced
window, cut down to what the per-layer readers and the breakdown read.

The benchmark marks the end of every iteration with a user annotation
named MARK; the traced window runs from the first mark to the last, on
the thread that made them.  A device interval is a kernel, a memcpy or a
memset on the device; in a rehearsal on the CPU, where there is no
device, an operator on the CPU stands in for it.
"""

from __future__ import annotations

import bisect

MARK = "bench.iteration"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME_CHARS = 160


def _kind(e, host_names=frozenset()) -> str:
    """kernel, gpu_memcpy or gpu_memset for a device event, and
    gpu_user_annotation for a host range the profiler mirrors on the
    device timeline (it carries a host event's name); cuda_runtime or
    cpu_op for a host event.  By the event's device and name, which every
    version of the profiler gives."""
    name = e.name()
    if "CUDA" in str(e.device_type()):
        if name in host_names or (hasattr(e, "is_user_annotation")
                                  and e.is_user_annotation()):
            return "gpu_user_annotation"
        return ("gpu_memcpy" if name.startswith("Memcpy")
                else "gpu_memset" if name.startswith("Memset") else "kernel")
    return "cuda_runtime" if name.startswith("cuda") else "cpu_op"


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def _merge(intervals):
    """Sorted, disjoint union of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarize(prof, on_card: bool = True) -> dict | None:
    """{window_ns, steps, busy_ns, kernel_ns {name: ns}, host_wait_ns,
    gaps [[host activity, ns]], device_kinds} over the traced window, or
    None when the profiler recorded fewer than two marks or no device
    activity.  `prof` is a stopped torch.profiler.profile."""
    device_kinds = DEVICE_KINDS if on_card else ("cpu_op",)
    events = prof.profiler.kineto_results.events()
    host_names = frozenset(e.name() for e in events
                           if "CUDA" not in str(e.device_type()))
    marks = sorted((e.start_ns(), e.start_thread_id()) for e in events
                   if e.name() == MARK)
    if len(marks) < 2:
        return None
    w0, w1 = marks[0][0], marks[-1][0]
    tid = marks[0][1]
    device, kernel_ns, memcpy_name = [], {}, {}
    for e in events:
        kind = _kind(e, host_names)
        if kind not in device_kinds:
            continue
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if kind == "gpu_memcpy":
            memcpy_name[e.correlation_id()] = e.name()
        if t <= s:
            continue
        device.append((s, t))
        if kind in ("kernel", "cpu_op"):
            kernel_ns[e.name()] = kernel_ns.get(e.name(), 0) + (t - s)
    if not device:
        return None
    busy = _merge(device)
    host, wait = [], 0
    for e in events:
        if (e.start_thread_id() != tid or e.name() == MARK
                or _kind(e, host_names) in device_kinds + ("gpu_user_annotation",)):
            continue
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if t <= s:
            continue
        name = e.name()
        if _kind(e, host_names) == "cuda_runtime" and (
                name.endswith("Synchronize") or (
                    name.startswith("cudaMemcpy")
                    and "DtoH" in memcpy_name.get(e.correlation_id(), ""))):
            wait += t - s
        host.append((e.start_ns(), -e.end_ns(), name))
    return dict(window_ns=w1 - w0, steps=len(marks) - 1,
                busy_ns=sum(t - s for s, t in busy), kernel_ns=kernel_ns,
                host_wait_ns=wait, gaps=_gaps(busy, w0, w1, sorted(host)))


def _gaps(busy, w0, w1, host):
    """Idle time on the device in the window, summed by the innermost host
    event running at each gap's midpoint: [[name, ns]], longest first."""
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    mids = sorted(((s + t) // 2, t - s) for s, t in gaps)
    starts = [h[0] for h in host]
    stack, i, total = [], 0, {}
    for mid, length in mids:
        j = bisect.bisect_right(starts, mid)
        while i < j:
            s, neg_end, name = host[i]
            while stack and -stack[-1][1] <= s:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and -stack[-1][1] <= mid:
            stack.pop()
        name = stack[-1][2] if stack else "host outside any traced op"
        total[name] = total.get(name, 0) + length
    return sorted(([k, v] for k, v in total.items()), key=lambda kv: -kv[1])[:TOP]


class TraceView:
    """What a per-layer reader reads: every rank's summary, and the run's
    own facts (`facts`: the configuration, the scene's spheres and lights,
    the power limit, and "work", the reference's count of a frame's work
    units, summed over ranks)."""

    def __init__(self, summaries: list, facts: dict):
        self.ranks = summaries
        self.facts = facts

    def per_step_ms(self, summary: dict, ns: float) -> float:
        return ns / summary["steps"] / 1e6

    def kernel_ns(self, summary: dict, match) -> int:
        return sum(v for k, v in summary["kernel_ns"].items() if match(k))

    def mean_over_ranks(self, fn) -> float:
        return sum(fn(s) for s in self.ranks) / len(self.ranks)

    def work(self) -> dict:
        return self.facts["work"]


def kernel_named(*names):
    """A match for kernel names that are one of `names`, or hold one
    followed by its argument list or template arguments."""
    keys = [(n + "(", n + "<") for n in names]

    def match(kernel: str) -> bool:
        return kernel in names or any(a in kernel or b in kernel
                                      for a, b in keys)
    return match


def breakdown(summary: dict) -> dict:
    """The result line's "breakdown": the device operations that took most
    time and the longest idle gaps, in seconds."""
    ops = sorted(summary["kernel_ns"].items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[_short(k), v / 1e9] for k, v in ops],
            "idle_gaps": [[_short(k), v / 1e9] for k, v in summary["gaps"]]}


# The program's kernels by the names of their __global__ functions.
K1 = kernel_named("trace_fwd_kernel")
K2 = kernel_named("trace_bwd_kernel")
K3 = kernel_named("wf_level_kernel")
K4 = kernel_named("wf_level_bwd_kernel")
K5 = kernel_named("wf_compact_kernel", "wf_tail_kernel")
K6 = kernel_named("wf_uncompact_kernel")


def nccl(kernel: str) -> bool:
    return "nccl" in kernel.lower()
