"""Time the forward kernel built from two sources, in turns on one card.

    python -m raytpu_torch.tools.kernel_ab --a OLD/raytpu_torch/csrc/trace_fwd.cu

--b defaults to this checkout's raytpu_torch/csrc/trace_fwd.cu.  Both are
built with the port's nvcc flags (a source's local headers are read from
its own directory).  The script checks that the two give bit-identical
frames of the default scene, then renders each config 30 times back to
back per timing, in the order A, B, B, A for each pair, timed with CUDA
events, and prints the card, each build's ptxas resources and every time.
Compare two sources only within one run: cards and power limits differ
between machines.
"""

from __future__ import annotations

import argparse
import subprocess
from pathlib import Path

import torch

from raytpu_torch.config import BENCH_CONFIGS
from raytpu_torch.kernels import trace_cuda
from raytpu_torch.scene import default_scene


def _kernel(name: str, source: str):
    k = trace_cuda.CudaKernel(f"trace_fwd_{name}", "trace_fwd.cu",
                              trace_cuda.TRACE_FWD.symbol,
                              trace_cuda.TRACE_FWD.argtypes)
    k.source = Path(source).resolve()
    return k


def _render(kernel, scene, cfg):
    saved = trace_cuda.TRACE_FWD
    trace_cuda.TRACE_FWD = kernel
    try:
        return trace_cuda.render_pixels_cuda(scene, cfg)
    finally:
        trace_cuda.TRACE_FWD = saved


def _ms_per_frame(kernel, scene, cfg, frames: int = 30) -> float:
    for _ in range(3):
        _render(kernel, scene, cfg)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(frames):
        _render(kernel, scene, cfg)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / frames


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raytpu_torch.tools.kernel_ab",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--a", required=True, help="trace_fwd.cu of version A")
    ap.add_argument("--b", default=str(trace_cuda.TRACE_FWD.source),
                    help="trace_fwd.cu of version B (default: this checkout)")
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
    kernels = {"A": _kernel("a", args.a), "B": _kernel("b", args.b)}
    for label, k in kernels.items():
        k.build()
        res = [line.strip() for line in k.build_log.splitlines()
               if "registers" in line or "spill" in line]
        print(f"{label} {k.source}: {res}")
    scene = default_scene(device="cuda:0")
    for key in args.config:
        cfg = BENCH_CONFIGS[key]
        same = torch.equal(_render(kernels["A"], scene, cfg),
                           _render(kernels["B"], scene, cfg))
        print(f"{key}: A and B bit-identical: {same}")
        for _ in range(args.pairs):
            for label in ("A", "B", "B", "A"):
                ms = _ms_per_frame(kernels[label], scene, cfg)
                print(f"{key} {label}: {ms:.4f} ms/frame")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
