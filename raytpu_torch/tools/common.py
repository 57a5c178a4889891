"""What the measuring tools (bench_all, step_bench, shard_balance,
wf_breakdown) share: the device a tool runs on, the card's name and power
limit beside its numbers, the six kernels' launch counters, and the timing
of a call.

Each tool runs on this process's card unless given --cpu; without a card
and without --cpu it exits 2, and the CPU is never measured in the card's
place.  Under --cpu each kernel's wrapper runs its plain version."""

from __future__ import annotations

import sys

import torch

from raytpu_torch.device import local_device, nvidia_smi_line
from raytpu_torch.kernels.trace_cuda import TRACE_BWD, TRACE_FWD
from raytpu_torch.kernels.wavefront import (WF_COMPACT, WF_LEVEL,
                                            WF_LEVEL_BWD, WF_UNCOMPACT)

# Every kernel of the port, by the names of chip_smoke.py's kernels line.
KERNELS = {"trace_fwd": TRACE_FWD, "trace_bwd": TRACE_BWD,
           "wf_level": WF_LEVEL, "wf_compact": WF_COMPACT,
           "wf_level_bwd": WF_LEVEL_BWD, "wf_uncompact": WF_UNCOMPACT}


def tool_device(cpu: bool):
    """The CPU under --cpu, else this process's card; None, with the reason
    on stderr, when there is no card."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print("error: no CUDA device found; pass --cpu to run on the CPU",
              file=sys.stderr)
        return None
    return local_device()


def card_fields(device) -> dict:
    """The card's name and power limit as nvidia-smi prints them ("cpu" and
    None on the CPU)."""
    if device.type != "cuda":
        return {"device": str(device), "power_limit": None}
    return {"device": torch.cuda.get_device_name(device),
            "power_limit": nvidia_smi_line(device).rsplit(",", 1)[1].strip()}


def counted(measure, launches: dict, key: str, kernels: dict = KERNELS):
    """measure()'s result; each of `kernels`' launches in it go to
    launches[key]."""
    for kernel in kernels.values():
        kernel.launches = 0
    out = measure()
    launches[key] = {name: k.launches for name, k in kernels.items()}
    return out


def timed(fn, timer, reps: int):
    """(seconds of a first call of fn, [seconds of each of `reps` calls
    after it]) by `timer`: Timer() for the host clock, each call's CUDA
    result waited for; Timer(device) for CUDA events on a card."""
    with timer.section("first") as box:
        box["value"] = fn()
    for _ in range(reps):
        with timer.section("run") as box:
            box["value"] = fn()
    times = timer.times()
    return times["first"][0], times["run"]


def ms(times) -> list:
    return [t * 1e3 for t in times]
