"""Time a dense kernel built from two sources, in turns on one card.

    python -m raytpu_torch.tools.kernel_ab --a OLD/raytpu_torch/csrc/trace_fwd.cu
    python -m raytpu_torch.tools.kernel_ab --kernel trace_bwd \
        --a OLD/raytpu_torch/csrc/trace_bwd.cu --config config3

--b defaults to this checkout's source of the kernel.  Both are built with
the port's nvcc flags (a source's local headers are read from its own
directory).  For the forward (trace_fwd) the script checks that the two
give bit-identical frames of the default scene and times frames; for the
backward (trace_bwd) it prints the largest difference between the two
gradients relative to their scale (the kernel sums with atomics, so the
last bits vary) and times the kernel's wrapper, grad_pixels_cuda, on the
default scene with a seeded normal cotangent on every pixel.  Each timing
is 30 runs back to back, in the order A, B, B, A for each pair, with CUDA
events; the script prints the card, each build's ptxas resources and
every time.  Compare two sources only within one run: cards and power
limits differ between machines.
"""

from __future__ import annotations

import argparse
import subprocess
from pathlib import Path

import torch

from raytpu_torch.config import BENCH_CONFIGS
from raytpu_torch.kernels import trace_cuda
from raytpu_torch.scene import default_scene, scene_leaves


def _kernel(which: str, name: str, source: str):
    base = getattr(trace_cuda, which.upper())
    k = trace_cuda.CudaKernel(f"{which}_{name}", f"{which}.cu", base.symbol,
                              base.argtypes)
    k.source = Path(source).resolve()
    return k


def _run(which: str, kernel, fn):
    """fn() with the kernel `which` of trace_cuda replaced by `kernel`."""
    attr = which.upper()
    saved = getattr(trace_cuda, attr)
    setattr(trace_cuda, attr, kernel)
    try:
        return fn()
    finally:
        setattr(trace_cuda, attr, saved)


def _ms_per_run(which: str, kernel, fn, runs: int = 30) -> float:
    for _ in range(3):
        _run(which, kernel, fn)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        _run(which, kernel, fn)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def _workload(which: str, cfg):
    """The function timed for `which` at `cfg`, and how to compare two of
    its results."""
    if which == "trace_fwd":
        scene = default_scene(device="cuda:0")
        return (lambda: trace_cuda.render_pixels_cuda(scene, cfg),
                lambda a, b: f"bit-identical: {torch.equal(a, b)}")
    scene = default_scene(device="cuda:0")
    gen = torch.Generator(device="cuda:0").manual_seed(0)
    g = torch.randn((cfg.num_pixels, 3), generator=gen, device="cuda:0")

    def compare(a, b):
        worst = max(float((x - y).abs().max()) / max(float(y.abs().max()), 1e-30)
                    for x, y in zip(scene_leaves(a), scene_leaves(b)))
        return f"gradients differ by at most {worst:.3e} x scale"

    return (lambda: trace_cuda.grad_pixels_cuda(scene, cfg, g), compare)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raytpu_torch.tools.kernel_ab",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernel", default="trace_fwd",
                    choices=["trace_fwd", "trace_bwd"])
    ap.add_argument("--a", required=True, help="the kernel's source, version A")
    ap.add_argument("--b", default=None,
                    help="the kernel's source, version B (default: this checkout)")
    ap.add_argument("--config", nargs="+", default=["config3", "golden"],
                    choices=sorted(BENCH_CONFIGS))
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    which = args.kernel
    b = args.b or str(getattr(trace_cuda, which.upper()).source)
    kernels = {"A": _kernel(which, "a", args.a), "B": _kernel(which, "b", b)}
    for label, k in kernels.items():
        k.build()
        res = [line.strip() for line in k.build_log.splitlines()
               if "registers" in line or "spill" in line]
        print(f"{label} {k.source}: {res}")
    unit = "frame" if which == "trace_fwd" else "call"
    for key in args.config:
        fn, compare = _workload(which, BENCH_CONFIGS[key])
        print(f"{key}: A and B {compare(_run(which, kernels['A'], fn), _run(which, kernels['B'], fn))}")
        for _ in range(args.pairs):
            for label in ("A", "B", "B", "A"):
                ms = _ms_per_run(which, kernels[label], fn)
                print(f"{key} {which} {label}: {ms:.4f} ms/{unit}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
