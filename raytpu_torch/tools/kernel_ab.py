"""Time a kernel built from two sources, in turns on one card.

    python -m raytpu_torch.tools.kernel_ab --a OLD/raytpu_torch/csrc/trace_fwd.cu
    python -m raytpu_torch.tools.kernel_ab --kernel trace_bwd \
        --a OLD/raytpu_torch/csrc/trace_bwd.cu --config config3
    python -m raytpu_torch.tools.kernel_ab --kernel wf_compact \
        --a OLD/raytpu_torch/csrc/wf_compact.cu
    python -m raytpu_torch.tools.kernel_ab --kernel wf_level \
        --a OLD/raytpu_torch/csrc/wf_level.cu

--b defaults to this checkout's source of the kernel.  Both are built with
the port's nvcc flags (a source's local headers are read from its own
directory).  For the forward (trace_fwd) the script checks that the two
give bit-identical frames of the default scene and times frames; for the
backward (trace_bwd) it prints the largest difference between the two
gradients relative to their scale (the kernel sums with atomics, so the
last bits vary) and times the kernel's wrapper, grad_pixels_cuda, on the
default scene with a seeded normal cotangent on every pixel.  For the
live-ray compaction (wf_compact) it takes config 5's chunk 0 (4,202,496
camera rays of random_scene(256, seed=3) at 1920x1080 d6 3x3, the "auto"
ladder's first rung), traces it level by level with this checkout's K3
and K5, and times the 6 compactions of the chunk through each source,
without and with the destination index (the forward and the training
path), after checking that the two give bit-identical outputs at every
level.  A source with the entries raytpu_wf_count and raytpu_wf_scatter
is the two-pass design (a count kernel, torch.cumsum of the block counts,
a scatter kernel) and is driven as its wrapper drove it; one with
raytpu_wf_compact and raytpu_wf_compact_tail is the single-pass design.
For the level kernel (wf_level, K3 with its BVH walk) it traces the same
chunk level by level with this checkout's K3 and K5 and times the 7
levels' K3 launches through each source, without and with the selections
`sel` (the forward and the training path), after checking that the two
give bit-identical emissions, children and `sel` at every level.
Each timing is 30 runs back to back, in the order A, B, B, A for each
pair, with CUDA events; the script prints the card, each build's ptxas
resources and every time.  Compare two sources only within one run: cards
and power limits differ between machines.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import torch

from raytpu_torch.config import BENCH_CONFIGS
from raytpu_torch.kernels import trace_cuda, wavefront
from raytpu_torch.scene import default_scene, random_scene, scene_leaves

_KERNELS = {"trace_fwd": trace_cuda, "trace_bwd": trace_cuda,
            "wf_compact": wavefront, "wf_level": wavefront}


def _kernel(which: str, name: str, source: str):
    base = getattr(_KERNELS[which], which.upper())
    k = trace_cuda.CudaKernel(f"{which}_{name}", f"{which}.cu", base.symbol,
                              base.argtypes)
    k.source = Path(source).resolve()
    return k


def _run(which: str, kernel, fn):
    """fn() with the kernel `which` of its module replaced by `kernel`."""
    module, attr = _KERNELS[which], which.upper()
    saved = getattr(module, attr)
    setattr(module, attr, kernel)
    try:
        return fn()
    finally:
        setattr(module, attr, saved)


def _ms(fn, runs: int = 30) -> float:
    """ms a run of fn() takes in `runs` runs back to back between two CUDA
    events, after 3 warm-up runs."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
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


def _ok(err: int):
    if err != 0:
        raise RuntimeError(f"launch failed: CUDA error {err}")


def _two_pass_compact(lib, children, pid, cap, n_slots, return_dst):
    """The two-pass design's wrapper: count kernel, torch.cumsum of the
    1024-child block counts, scatter kernel."""
    device = children.device
    kids = children.shape[1]
    counts = torch.empty(-(-kids // 1024), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _ok(lib.raytpu_wf_count(children.data_ptr(), kids, counts.data_ptr(), 0, stream))
    incl = torch.cumsum(counts, dim=0, dtype=torch.int64)
    starts, total = incl - counts, incl[-1]
    state = torch.empty((wavefront.N_STATE, cap), dtype=torch.float32, device=device)
    out_pid = torch.empty(cap, dtype=torch.int32, device=device)
    dst = torch.empty(kids, dtype=torch.int32, device=device) if return_dst else None
    _ok(lib.raytpu_wf_scatter(
        children.data_ptr(), kids, pid.data_ptr(), starts.data_ptr(),
        total.data_ptr(), cap, n_slots, state.data_ptr(), out_pid.data_ptr(),
        dst.data_ptr() if return_dst else None, 0, stream))
    out = (state, out_pid, torch.clamp(total - cap, min=0), torch.clamp(total, max=cap))
    return (*out, dst) if return_dst else out


def _compactor(kernel):
    """compact(children, pid, cap, n_slots, return_dst) through the library
    built from `kernel`'s source, whichever design it holds."""
    kernel.build()
    lib = ctypes.CDLL(str(kernel.library_path()))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if hasattr(lib, "raytpu_wf_count"):
        lib.raytpu_wf_count.argtypes = [p, ll, p, i, p]
        lib.raytpu_wf_scatter.argtypes = [p, ll, p, p, p, ll, i, p, p, p, i, p]
        return lambda *a: _two_pass_compact(lib, *a)
    kernel.entries = dict(wavefront.WF_COMPACT.entries)
    return lambda *a: _run("wf_compact", kernel, lambda: wavefront.compact(*a))


def _chunk0():
    """Config 5's scene, tables and tree, its chunk 0 traced level by level
    with this checkout's K3 and K5: [(state, pid)] of the 7 levels, the
    (children, pid, keep) of the 6 compactions, and the slots a chunk."""
    from raytpu_torch import render

    dev = torch.device("cuda:0")
    c5 = BENCH_CONFIGS["config5"]
    scene = random_scene(256, seed=3, device=dev)
    tables = trace_cuda.scene_tables(scene)
    bvh = wavefront.build_bvh(*tables[:2])
    chunk, ws, cap, n_chunks = wavefront.wavefront_sizes(
        c5, render.WF_AUTO_CHUNK, render.WF_AUTO_LADDER[0])
    state, pid = wavefront.chunk_camera_state(c5, chunk, n_chunks, 0,
                                              c5.num_pixels, device=dev)
    states, levels = [state], []
    for _ in range(c5.max_depth):
        _, kids = wavefront.wf_level(scene, state, True, tables, bvh)
        keep = min(2 * state.shape[1], cap)
        levels.append((kids, pid, keep))
        state, pid = wavefront.compact(kids, pid, keep, ws)[:2]
        states.append(state)
    return scene, tables, bvh, states, levels, ws


def _level_ab(kernels, pairs: int):
    """A/B the level kernel over config 5's chunk 0, every level."""
    scene, tables, bvh, states, _, _ = _chunk0()
    last = len(states) - 1

    def levels(label, with_sel):
        return [_run("wf_level", kernels[label],
                     lambda: wavefront.wf_level(scene, st, i < last, tables, bvh,
                                                return_sel=with_sel))
                for i, st in enumerate(states)]

    for with_sel in (False, True):
        path = "training path (with sel)" if with_sel else "forward path"
        same = all(all((x is None and y is None) or torch.equal(x, y)
                       for x, y in zip(a, b))
                   for a, b in zip(levels("A", with_sel), levels("B", with_sel)))
        print(f"config5 chunk 0, {len(states)} levels, {path}: A and B "
              f"bit-identical: {same}")
        for _ in range(pairs):
            for label in ("A", "B", "B", "A"):
                ms = _ms(lambda: levels(label, with_sel))
                print(f"config5 chunk 0 wf_level {label} ({path}): "
                      f"{ms:.4f} ms/chunk")


def _compact_ab(kernels, pairs: int):
    """A/B the compaction over config 5's chunk 0, every level."""
    _, _, _, _, levels, ws = _chunk0()
    fns = {label: _compactor(k) for label, k in kernels.items()}
    for dst in (False, True):
        path = "training path (with dst)" if dst else "forward path"
        same = all(all(torch.equal(x, y) for x, y in zip(fns["A"](*lv, ws, dst),
                                                          fns["B"](*lv, ws, dst)))
                   for lv in levels)
        print(f"config5 chunk 0, {len(levels)} compactions, {path}: A and B "
              f"bit-identical: {same}")
        for _ in range(pairs):
            for label in ("A", "B", "B", "A"):
                ms = _ms(lambda: [fns[label](*lv, ws, dst) for lv in levels])
                print(f"config5 chunk 0 wf_compact {label} ({path}): "
                      f"{ms:.4f} ms/chunk")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="raytpu_torch.tools.kernel_ab",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--kernel", default="trace_fwd", choices=sorted(_KERNELS))
    ap.add_argument("--a", required=True, help="the kernel's source, version A")
    ap.add_argument("--b", default=None,
                    help="the kernel's source, version B (default: this checkout)")
    ap.add_argument("--config", nargs="+", default=["config3", "golden"],
                    choices=sorted(BENCH_CONFIGS),
                    help="the dense kernels' frames (wf_compact, wf_level: "
                         "config 5)")
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"card: {smi}")
    which = args.kernel
    b = args.b or str(getattr(_KERNELS[which], which.upper()).source)
    kernels = {"A": _kernel(which, "a", args.a), "B": _kernel(which, "b", b)}
    for label, k in kernels.items():
        k.build()
        res = [line.strip() for line in k.build_log.splitlines()
               if "registers" in line or "spill" in line]
        print(f"{label} {k.source}: {res}")
    if which in ("wf_compact", "wf_level"):
        (_compact_ab if which == "wf_compact" else _level_ab)(kernels, args.pairs)
        return 0
    unit = "frame" if which == "trace_fwd" else "call"
    for key in args.config:
        fn, compare = _workload(which, BENCH_CONFIGS[key])
        print(f"{key}: A and B {compare(_run(which, kernels['A'], fn), _run(which, kernels['B'], fn))}")
        for _ in range(args.pairs):
            for label in ("A", "B", "B", "A"):
                ms = _ms(lambda: _run(which, kernels[label], fn))
                print(f"{key} {which} {label}: {ms:.4f} ms/{unit}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
