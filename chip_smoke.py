#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (raytpu_torch) once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
result lines):
  1. a CUDA device is present; print its nvidia-smi name and power limit;
  2. build every kernel (trace_fwd, trace_bwd, wf_level, wf_compact,
     wf_level_bwd, wf_uncompact, oracle) from raytpu_torch/csrc, one nvcc
     each, all started together, with wf_level.cu's counting host build
     (g++ -DRT_BVH_COUNT) and oracle.cu's host build (g++); print every
     instance's ptxas resources and hold K1's and K2's reference
     instances' (the previous designs, kept as they were) to the lines
     they had before the sphere queries became a policy (the policies leave
     their code as it was), and the oracle's stack frames within the stack
     its entry asks for (a base and one level a unit of its cap);
  3. hold the forward kernel against its plain PyTorch version on the card,
     under the forward contract of tests/test_pallas.py (outlier fraction
     <= 1% at 1e-2*scale, mean abs diff < 1e-3*scale), and bit for bit
     against its reference instance (the previous design: a thread a
     pixel) there and at alias 1-4 and 12, on a strided set and at 4096
     spheres and 1024 lights;
  4. hold the backward kernel against its plain version (autograd of the
     eager tracer) on the same cases, under the gradient contract of
     tests/test_pallas.py:304-314 (rtol 5e-2 where |plain| > 1e-3*scale),
     the cotangent zeroed on the pixels whose forwards differ by more than
     1e-5*scale, and against its reference instance (every table within
     1e-5 x scale: atomics sum in another order);
  5. anchor to the JAX reference without JAX: the forward kernel against
     the linear golden written by raytpu.trace (tests/goldens), and bit for
     bit against its reference instance;
  6. the render path: raytpu_torch.cli.main(["-o", <tmp>.ppm]), the golden
     800x600 depth-5 3x3 render with --backend auto, counting trace_fwd's
     launches and holding the image against the plain version and, bit for
     bit, against K1's reference instance;
  7. the training path: raytpu_torch.examples.fit_scene.main at config 3
     (640x480, depth 4, 3x3 AA), 3 geometry steps with --backend cuda (the
     kernel pair, which "auto" also takes for this scene and frame),
     counting both kernels' launches; the fit's first gradient against
     the kernel's and, on the masked cotangent, against the plain version
     and K2's reference instance;
  8. time the config-3 training step and the backward kernel alone, K2
     against its reference instance in turns; K1 against its reference
     instance bit for bit at config 3 with alias 1-4, in turns, by the
     profiler's kernel time and back to back, and its wrapper's host work
     split by a host clock; then config 3 and the golden frame's forward,
     kernel against plain version, with CUDA events (median of 5 after 1
     warm-up);
  9. each kernel's bound at config 3: operations counted from the sources
     over the work the plain version's masks show, against 67 TFLOP/s, and
     bytes against 3.35 TB/s;
 10. the wavefront's kernels against their plain versions at config 5's
     widths (random_scene(256, seed=3), chunk 0 at the auto ladder's first
     rung): the level kernel (K3) under the forward contract at level 0 and
     the first two compacted levels, the compaction (K5) bit for bit, also
     at a capacity below the live count so that its drop path runs, and on
     its edge cases (no children, less than a tile, every child dead or
     live, a capacity below the live count or above the children, a
     4096-tile look-back chain) and back to back on one stream;
 11. the wavefront path: raytpu_torch.cli.main at config 5 (1920x1080,
     depth 6, 3x3 AA, 256 spheres) with --backend wavefront --strict-drops,
     counting both kernels' launches (chunks x 7 and chunks x 6 x 2 per
     ladder rung tried), no dropped ray, the PPM on disk, and the frame
     against K1's under tests/test_wavefront.py:25-36's contract;
 12. times with CUDA events: the config-5 frame, wavefront against K1 (in
     turns, median of 3 after 1 warm-up); a torch.profiler breakdown of one
     wavefront frame; a chunk x capacity sweep at config 5 with the drops
     of each point; the "auto" crossover cells at 640x480, wavefront against
     K1; K3 and K5 alone on config 5's chunk 0 at every level against their
     plain versions, K3 (through its BVH) against its brute-force reference
     instance bit for bit (emissions, children, sel) and in turns (ref, new,
     new, ref), and their bounds for that work: K3's from the boxes and
     spheres a counting host build of the walk tests on a 1-in-64 sample of
     each level, beside the reference algorithm's, and its bytes from each
     level's live count; K3 against its reference the same way on two
     scenes outside config 5, the default scene (N = 3) and
     random_scene(3000) (the tree read through the read-only cache), each
     at 640x480 d4 3x3;
 13. the wavefront's backward kernels against their plain versions at
     config 5's widths (chunk 0 at the training ladder's first rung, level 0
     and the first two compacted levels, seeded cotangents zeroed on the
     rays whose forwards differ): the level backward (K4) under the
     gradient contract per ray and per scene table, with exact zeros on
     dead rays; the compaction's transpose (K6, from K5's destination
     index) bit for bit, also at a capacity below the live count, and K5
     with its destination index on phase 10's edge cases;
 14. the wavefront training path: raytpu_torch.grad.fit_scene at config 5
     with backend="wavefront", 3 steps of matte and light colours from the
     fit example's perturbation, counting K3, K4, K5 and K6 launches (chunks
     x 7, chunks x 7, chunks x 6 x 2, chunks x 6 per step tried, K3's and
     K5's twice over where a step has more than one chunk: each chunk is
     checkpointed and its backward re-runs its forward), no dropped
     ray, the loss falling or holding, and the first step's loss and
     gradient against the kernel pair's (tests/test_wavefront.py:196-219's
     contract); then the fit example with --backend wavefront at config 3;
 15. times: the config-5 training step, wavefront against the kernel pair
     (in turns, median of 3 after 1 warm-up) with its peak memory; a
     torch.profiler breakdown of one wavefront step; a chunk sweep of the
     step; the training crossover at the ten 640x480 cells of phase 12 (the
     N=3 d4 cell three times); K4 and K6 alone on config 5's chunk 0 at
     every level against their plain versions (K6 bit for bit, and faster
     than torch.zeros + index_copy_, which it must be), with K5 on that
     path with and without its destination index; K4 (from K3's sel)
     against its reference instance (re-running the brute-force queries),
     d_state bit for bit and the tables within 1e-5 x scale, in turns;
     their bounds, K4's beside the reference algorithm's;
 16. inputs the dense kernels do not take, through render_single,
     loss_and_grad and fit_scene under "auto": the default scene at depth
     10, random_scene(5000), 1100 lights, and 64 lights at N=64 (through
     K1 and K2's shared-table instance), each frame against the plain
     version and each gradient under the gradient contract; the CLI at
     depth 10; image_loss and exposure_image_loss with a strided gid on a
     CUDA scene against the CPU.
 17. the sharded paths (raytpu_torch.parallel): a 1-rank "nccl" group in
     this process renders config 5 through render_sharded (interleaved,
     the wavefront, no drop, the frame under the wavefront contract against
     phase 11's) and takes one loss_and_grad_sharded step (no drop; loss
     rtol 1e-5 and every leaf within 2e-3 x scale of the one-device step;
     both timed); two "gloo" ranks sharing the card
     (raytpu_torch.tools.multiprocess_demo's "card" suite), block and
     interleaved: the config-3 frame through K1 bit for bit against
     render_single, the config-3 step through K1 + K2 and the config-5
     step through the wavefront, each within those tolerances of the
     one-device step, the drops summed, the config-5 step's time and peak
     memory per rank; and `torch.distributed.run --nproc-per-node 1 -m
     raytpu_torch.cli --sharded --interleave`, the golden PPM byte for
     byte against phase 6's.  Each path's kernels must have launched.
 18. the strict-semantics oracle (raytpu_torch.native, csrc/oracle.cu):
     the kernel bit for bit, NaN masks equal, against its plain version
     (raytpu_torch.oracle.render_oracle) on the card on three frames
     (default 96x72 cap 5, 64x48 cap 6 with double Fresnel, random_scene(24,
     seed=7) 48x32 2x2 cap 5) and against its g++ host build at mask
     0, fma_mask=1 and approx_mask=1; `python -m raytpu_torch.cli --oracle
     --width 400 --height 300` byte for byte against
     docs/renders/golden_400x300_strict.ppm; the CLI's --oracle at the
     golden 800x600 and at --oracle-cap 6 --fresnel-double, one oracle
     launch each, bit for bit against the plain version (so no NaN beyond
     its); default_scene() on the card and render_single on it one K1
     launch; the kernel and the plain version timed at 800x600 with CUDA
     events.
 19. raytpu's packed-tile training step and tile culling: three Adam steps
     of raytpu_torch.grad.loss_and_grad_packed at config 3 from the fit
     example's perturbed geometry against the true frame (pack_target
     once), one K1 and one K2 launch a step, each step against
     loss_and_grad(backend="cuda") on the same scene (loss rtol 1e-6,
     every leaf within 1e-5 x max |leaf|: K2 sums in another order); the
     golden frame through render_tiles_cuda_ad (469 tiles, 256 tail lanes
     equal to pixel P-1 bit for bit; two offset/count blocks whose lane j
     is pixel min(offset + j, P-1) bit for bit) and the gradient of a plain sum over
     the tiles against the flat output's, in the same bounds; the packed
     and flat steps timed in turns and pack_target alone (CUDA events,
     median of 5 after 1 warm-up), and both steps back to back, in this
     process and in a fresh one (host work late in this script has read
     slower than in a fresh process); kernels.culling's tile_bounds and beam_live_mask on config-5 chunk
     0's camera rays in 1024-ray tiles, card against CPU bit for bit, and
     conservative against the eager intersection (ray_sphere_t) on the
     card, with the live share.
 20. the bench: render_timed(scene, cfg, mesh, warmup, iters) and
     resolve_backend(backend, scene, cfg) positionally on the default
     scene at config 3, as raytpu's CLI calls them; then `python -m
     raytpu_torch.bench` in a fresh process, which must exit 0 with a
     positive headline, the forward and the step through "cuda", no
     dropped ray at config 5, and each timed key's launches those of its
     path: one K1 a forward, one K1 and one K2 a step, K3 and K5 and no
     K1 at config 5; its line is printed on a phase line.
 21. the wavefront's chunk loop at config 5's scene (random_scene(256,
     seed=3), depth 6, 3x3): (a) render_pixels_wavefront's 1920x1080 frame
     at streams 1, 2 and 4 (chunk c on CUDA side stream c % streams), no
     drop, each frame bit for bit streams=1's (within 1e-6 x max |frame| if
     streams=1 differs from itself: index_add_'s atomics), timed in turns
     (median of 5 after 1 warm-up, CUDA events) with each setting's peak
     memory (allocated, and reserved from an emptied cache: each side
     stream caches blocks of its own) and its summed kernel time over its
     wall time under torch.profiler (above 1 where kernels overlap); (b)
     the 1920x1080 training step through loss_and_grad_sharded (each of its
     chunks checkpointed) at streams 1 and 2, no drop, loss and leaves
     against K1 + K2 under phase 14's bound, timed in turns (median of 3
     after 1 warm-up) with its peak memory, beside the figures of the
     step that kept every chunk's residuals;
     (c) one 7680x4320 training step after 1 warm-up: no drop, a finite
     loss, a peak of at most 16 GiB, loss and leaves against one K1 + K2
     step under the same bound.  K3, K4, K5 and K6 must launch; their
     launches go into the kernels line's counts.
 22. the measuring tools (raytpu_torch.tools), each in a fresh process:
     `bench_all` over raytpu's five BASELINE configs (config 5 on
     random_scene(256, num_lights=4) at seed 0), exit 0, no `*_error` key,
     and each key's launches those of its path (a forward one K1 a call, a
     dense step one K1 and one K2 a call, the config-5 frame chunks x 7 K3
     and chunks x 6 x 2 K5 a call, the config-5 step twice those plus
     chunks x 7 K4 and chunks x 6 K6 a call, no other kernel);
     `step_bench` at its defaults; `shard_balance` at 1920x1080 3x3 over 4
     shards, in blocks and with --interleave; `wf_breakdown` at its
     defaults; each line printed on a phase line.
K1's and K2's launches in the kernels line are phase 7's, phase 19's and
phase 22's summed, K3's and K5's phase 11's, phase 21's and phase 22's,
K4's and K6's phase 14's, phase 21's and phase 22's, each path's count
beside them in "launches_by_path".
The last three lines are nvidia-smi's, the kernels JSON and
{"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens")
PEAK_FP32 = 67e12   # H100 SXM fp32 outside the tensor cores, FLOP/s
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s


def check(cond, message):
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {message}")


def contract(kernel, plain, frac_tol=0.01, mean_tol=1e-3):
    """Kernel vs plain under the forward contract; returns the stats."""
    k = np.asarray(kernel, np.float64)
    p = np.asarray(plain, np.float64)
    check(k.shape == p.shape, f"shape {k.shape} vs {p.shape}")
    check(np.isfinite(k).all(), "kernel output is not finite")
    scale = max(float(np.abs(p).max()), 1e-12)
    d = np.abs(k - p).reshape(-1, 3)
    stats = dict(outliers=float((d.max(axis=1) > 1e-2 * scale).mean()),
                 mean_over_scale=float(d.mean() / scale),
                 max_abs_err=float(d.max()) if d.size else 0.0)
    check(stats["outliers"] <= frac_tol,
          f"outlier fraction {stats['outliers']} > {frac_tol}")
    check(stats["mean_over_scale"] < mean_tol,
          f"mean abs diff {stats['mean_over_scale']} * scale >= {mean_tol}")
    return stats


def masked_cotangent(kernel_fwd, plain_fwd, g):
    """g with the pixels whose forwards differ by more than 1e-5*scale
    zeroed; returns (g, zeroed count)."""
    scale = plain_fwd.abs().max()
    bad = (kernel_fwd - plain_fwd).abs().amax(dim=1) > 1e-5 * scale
    g = g.clone()
    g[bad] = 0.0
    return g, int(bad.sum())


def grad_contract(kernel, plain, rtol=5e-2):
    """Gradient Scenes under tests/test_pallas.py:309-314; returns the worst
    relative error on the coordinates held and the largest absolute one."""
    from raytpu_torch.scene import LEAF_NAMES, scene_leaves

    worst = max_abs = 0.0
    for name, a, w in zip(LEAF_NAMES, scene_leaves(kernel), scene_leaves(plain)):
        a = a.detach().cpu().numpy().astype(np.float64).ravel()
        w = w.detach().cpu().numpy().astype(np.float64).ravel()
        check(np.isfinite(a).all() and np.isfinite(w).all(),
              f"{name}: gradient is not finite")
        max_abs = max(max_abs, float(np.abs(a - w).max()))
        big = np.abs(w) > 1e-3 * max(float(np.abs(w).max()), 1e-30)
        if big.any():
            rel = float((np.abs(a - w)[big] / np.abs(w[big])).max())
            check(rel <= rtol, f"{name}: relative gradient error {rel} > {rtol}")
            worst = max(worst, rel)
    return worst, max_abs


def ref_table_err(got, want, tol=1e-5, what="the reference instance"):
    """The largest |got - want| of any gradient leaf over that leaf's max
    |want|; fails above `tol` (atomics sum in another order, so not bit
    for bit).  `what` names `want` in the failure."""
    from raytpu_torch.scene import LEAF_NAMES, scene_leaves

    worst = 0.0
    for name, a, w in zip(LEAF_NAMES, scene_leaves(got), scene_leaves(want)):
        err = float((a - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        check(np.isfinite(err) and err <= tol,
              f"{name}: {err} x max |reference| off {what}")
        worst = max(worst, err)
    return worst


# The ptxas resource lines (sm_90a) of K1's and K2's reference instances
# (the previous designs, kept as they were) from before the sphere queries
# became a policy of trace_common.cuh: the brute-force policy they use must
# leave their code unchanged.  Keyed by library, then by the kernel's
# length-prefixed name in its mangled symbol.
BRUTE_FORCE_PTXAS = {
    "trace_fwd": ("20trace_fwd_ref_kernel", (
        "496 bytes stack frame, 20 bytes spill stores, 12 bytes spill loads",
        "Used 64 registers, used 1 barriers, 496 bytes cumulative stack size")),
    "trace_bwd": ("20trace_bwd_ref_kernel", (
        "2176 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads",
        "Used 128 registers, used 1 barriers, 2176 bytes cumulative stack size")),
}


def ptxas_by_entry(log):
    """{mangled kernel name: its resource lines} from an nvcc -Xptxas -v
    log, the lines without their prefix."""
    out, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1]
            out.setdefault(current, [])
        elif ("registers" in line or "stack frame" in line) and current:
            out[current].append(line.split("ptxas info    : ")[-1].strip())
    return out


def _stack_frames(log):
    """[(function, its "N bytes stack frame" line)] from an nvcc -Xptxas -v
    log, device functions included."""
    out, current = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            current = line.split("Function properties for")[-1].strip()
        elif "bytes stack frame" in line and current:
            out.append((current, line.strip()))
            current = None
    return out


def build_counting_host():
    """wf_level.cu built by g++ with -DRT_BVH_COUNT: the host traversal that
    counts the boxes and spheres each query tests.  Returns the library."""
    import ctypes
    import hashlib

    from raytpu_torch.kernels.trace_cuda import BUILD_DIR, CSRC, _sources

    src = CSRC / "wf_level.cu"
    h = hashlib.sha256(b"".join(p.read_bytes() for p in _sources(src))).hexdigest()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libwf_level_count_{h[:16]}.so"
    res = subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off",
                          "-DRT_BVH_COUNT", "-shared", "-fPIC", "-o", str(path),
                          str(src)], capture_output=True, text=True)
    check(res.returncode == 0, f"g++ counting build failed: {res.stderr}")
    lib = ctypes.CDLL(str(path))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.raytpu_wf_level_host.argtypes = [p, i, p, i, p, p, p, i, p, ll, i, p, p, p]
    lib.raytpu_bvh_counts_host.argtypes = [p]
    return lib


def median_ms(timer, name):
    return float(np.median(timer.times()[name])) * 1e3


# fp32 operations (+, -, *, /, sqrt, compare, select and min/max: one each)
# per unit of work, counted by hand from raytpu_torch/csrc/trace_common.cuh
# (forward) and trace_bwd.cu (adjoint).  A sphere test counts the 21
# operations every test does, not the 14 a real root adds; a spawning
# node's adjoint counts its Fresnel adjoint (50) even under total internal
# reflection, where it is skipped.
FWD_OPS = dict(sample=23, node=13, sphere=21, miss=3, live=36, light=21,
               shadow=22, shadow_sphere=37, lit=9, spawn=138, container=11,
               refl=30)
ADJ_OPS = dict(miss=6, live=150, shaded=45, lit=65, spawn=80, refl=97,
               refr=70)


def level_work(scene, state, work, spawn):
    """Add one bounce level's work units (FWD_OPS and ADJ_OPS keys but
    "sample") for the rays of `state` (origin, direction, intensity and the
    medium's matte, ior and opacity) to `work`, from the plain version's
    masks: nodes visited (intensity not all zero), misses, live hits,
    shaded hits and their lights, sphere tests until the first shadow
    blocker or container, spawning nodes and their children.  Returns the
    children's state when `spawn`."""
    import torch

    from raytpu_torch.ops.geometry import closest_hit, dot3, normalize, ray_sphere_t
    from raytpu_torch.ops.shading import K_SMALL_SHIFT, is_significant
    from raytpu_torch.trace import _trace_level

    sph, lights = scene.spheres, scene.lights
    n = sph.count

    def first_index(mask):  # (..., n) -> tests until the first True, else n
        first = torch.argmax(mask.to(torch.uint8), dim=-1) + 1
        return torch.where(mask.any(dim=-1), first, torch.full_like(first, n))

    o, dirs, inten = state[0], state[1], state[2]
    visited = inten.abs().amax(dim=1) > 0
    nv = int(visited.sum())
    work["node"] += nv
    work["sphere"] += nv * n
    hit = closest_hit(o, dirs, sph)
    work["miss"] += int((visited & ~hit.found).sum())
    live = visited & hit.found & is_significant(inten)
    work["live"] += int(live.sum())
    op = sph.opacity[hit.index]
    shaded = live & (op > 0)
    work["shaded"] += int(shaded.sum())
    work["light"] += int(shaded.sum()) * lights.count
    dist = lights.pos - hit.point[:, None, :]
    gap = dot3(dist, dist)
    ldir = normalize(dist)
    facing = shaded[:, None] & (dot3(hit.normal[:, None, :], ldir) > 0)
    t, found = ray_sphere_t(hit.point[:, None, :], ldir, sph.pos, sph.radius)
    blocking = found & (t < 1e3) & (t * t < gap[..., None])
    work["shadow"] += int(facing.sum())
    work["shadow_sphere"] += int(first_index(blocking)[facing].sum())
    work["lit"] += int((facing & ~blocking.any(dim=-1)).sum())
    if not spawn:
        return None
    spawning = live & (op < 1)
    work["spawn"] += int(spawning.sum())
    probe = hit.point + K_SMALL_SHIFT * dirs
    inside = ((probe[:, None, :] - sph.pos) ** 2).sum(-1) <= (sph.radius + 1e-6) ** 2
    work["container"] += int(first_index(inside)[spawning].sum())
    rays = o.shape[0]
    _, children = _trace_level(scene, *state, spawn=True)
    alive = children[2].abs().amax(dim=1) > 0  # [refr | refl]
    work["refr"] += int(alive[:rays].sum())
    work["refl"] += int(alive[rays:].sum())
    return children


def new_work():
    return dict.fromkeys(list(FWD_OPS) + list(ADJ_OPS), 0)


def tree_work(scene, cfg, chunk=16384):
    """Counts of the work units of FWD_OPS and ADJ_OPS in one dense frame:
    every camera sample's tree, level by level (level_work)."""
    import torch

    from raytpu_torch.trace import camera_rays

    work = new_work()
    gid_all = torch.arange(cfg.num_pixels, device=scene.device)
    with torch.no_grad():
        for gid in torch.split(gid_all, chunk):
            for si in range(cfg.alias_factor):
                for sj in range(cfg.alias_factor):
                    d = camera_rays(cfg, si, sj, gid)
                    b = d.shape[0]
                    work["sample"] += b
                    state = (torch.zeros_like(d), d, torch.ones_like(d),
                             scene.bg.matte.expand(b, 3), scene.bg.ior.expand(b),
                             scene.bg.opacity.expand(b))
                    for level in range(cfg.max_depth + 1):
                        state = level_work(scene, state, work, level < cfg.max_depth)
    return work


def wavefront_level_work(scene, state, spawn, part=32768):
    """level_work for the wavefront's (10, R) state (the medium as a sphere
    index), in parts of `part` rays; returns the work counts."""
    import torch

    from raytpu_torch.trace import _gather_medium

    work = new_work()
    with torch.no_grad():
        for p in torch.split(state, part, dim=1):
            medium = _gather_medium(scene.spheres, scene.bg, p[9].to(torch.int64))
            level_work(scene, (p[0:3].T, p[3:6].T, p[6:9].T, *medium), work, spawn)
    return work


def bound_ms(work, n_tbl, pixels, backward):
    """(least time in ms, "operations" or "bytes") for one frame's forward
    or backward: the larger of its operations over the fp32 peak and its
    bytes (tables and pixels, each once) over the memory rate."""
    ops = sum(FWD_OPS[k] * work[k] for k in FWD_OPS)
    if backward:
        ops += sum(ADJ_OPS[k] * work[k] for k in ADJ_OPS)
    nbytes = 4 * (2 * n_tbl + 3 * pixels)
    t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", ops, nbytes)


def events_ms(fn, reps=3, warmup=1):
    """(median ms of `reps` runs of fn() between CUDA events after `warmup`
    runs, the last result)."""
    import torch

    out = None
    for _ in range(warmup):
        out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), out


def turns(ref, new, rounds=2):
    """ref and new timed in turns ref, new, new, ref (`rounds` times, after
    one warm-up each), each run between CUDA events: (median ms of ref,
    of new, the warm-up results of ref and of new)."""
    ref_out, new_out = ref(), new()
    times = {ref: [], new: []}
    for _ in range(rounds):
        for fn in (ref, new, new, ref):
            times[fn].append(events_ms(fn, reps=1, warmup=0)[0])
    return (float(np.median(times[ref])), float(np.median(times[new])), ref_out,
            new_out)


def kernel_device_ms(fn, kernel, calls=20):
    """Device ms a launch of the kernel named `kernel` takes under
    torch.profiler over `calls` calls of fn back to back, or None when the
    profiler saw none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = n = 0
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == DeviceType.CUDA and f"::{kernel}(" in e.key:
            us += getattr(e, "self_device_time_total", None) or e.self_cuda_time_total
            n += e.count
    return us / 1e3 / n if n else None


def back_to_back_ms(fn, calls=30):
    """ms a call of fn takes in a run of `calls` calls between two CUDA
    events, after a warm-up: device time where the host keeps ahead."""
    import torch

    fn(), fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def host_us(fns, reps=200):
    """{name: host microseconds a call of fn takes, by perf_counter over
    `reps` calls}; the device work the calls enqueue is left to run."""
    import torch

    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
    return out


def same_bits(a, b):
    """Tensors equal bit for bit (floats compared as their int32 words)."""
    import torch

    if a is None or b is None:
        return a is None and b is None
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


# K5's edge cases: (parents, live fraction, capacity).  No children, fewer
# than one tile (4096 children), every child dead, every child live, a
# capacity below the live count, one above the children, and a look-back
# chain of 2048 tiles (each level of config 5's chunk 0 has 2,052).
COMPACT_CASES = {
    "no children": (0, 0.5, 4096),
    "less than a tile": (300, 0.6, 1024),
    "every child dead": (3000, 0.0, 2048),
    "every child live": (3000, 1.0, 8192),
    "capacity below the live count": (5000, 0.7, 3000),
    "capacity above the children": (1000, 0.5, 9000),
    "a long look-back chain": (1 << 22, 0.45, 1 << 22),
}


def seeded_children(parents, live_frac, seed, dev):
    """(10, 2 * parents) children as K3 writes them (a dead child is ten
    exact zeros) and the parents' pids, on the card."""
    import torch

    rng = np.random.default_rng(seed)
    kids = 2 * parents
    ch = rng.normal(size=(10, kids)).astype(np.float32)
    ch[9] = rng.integers(-1, 8, kids)
    ch[6:9][:, rng.random(kids) < 0.5] = 0.0
    ch[6 + rng.integers(0, 3, kids), np.arange(kids)] = 0.5 + rng.random(kids)
    ch[:, rng.random(kids) >= live_frac] = 0.0
    pid = rng.integers(0, 1 << 20, parents).astype(np.int32)
    return torch.from_numpy(ch).to(dev), torch.from_numpy(pid).to(dev)


def compact_edge_cases(dev, return_dst):
    """K5 bit for bit against compact_torch on COMPACT_CASES, then three
    compactions enqueued twice over with no synchronisation, each one's
    outputs freed before the next so that the allocator may hand it the
    last one's scratch (status words and ticket).  Returns a summary."""
    import torch

    from raytpu_torch.kernels.wavefront import compact, compact_torch

    for case, (parents, frac, cap) in COMPACT_CASES.items():
        ch, pid = seeded_children(parents, frac, len(case), dev)
        got = compact(ch, pid, cap, 37, return_dst=return_dst)
        torch.cuda.synchronize()
        want = compact_torch(ch, pid, cap, 37, return_dst=return_dst)
        check(all(same_bits(a, b) for a, b in zip(got, want)),
              f"K5 (dst {return_dst}) on '{case}': differs from compact_torch")
    inputs = [seeded_children(40000 + 999 * k, 0.3 + 0.2 * k, 50 + k, dev)
              for k in range(3)]
    wants = [compact_torch(ch, pid, 50000, 101, return_dst=return_dst)
             for ch, pid in inputs]
    torch.cuda.synchronize()
    kept = []
    for rep in range(2):
        for (ch, pid), want in zip(inputs, wants):
            got = compact(ch, pid, 50000, 101, return_dst=return_dst)
            if rep:
                kept.append((got, want))
            del got
    torch.cuda.synchronize()
    check(all(same_bits(a, b) for got, want in kept for a, b in zip(got, want)),
          f"K5 (dst {return_dst}) back to back on one stream: differs from "
          f"compact_torch")
    return (f"{len(COMPACT_CASES)} edge cases ({', '.join(COMPACT_CASES)}) and "
            f"6 compactions back to back on one stream bit-identical")


# fp32 operations of the tree walk (csrc/bvh.cuh): a slab test (6
# subtractions, 6 products, 6 min/max per axis pair, 6 clips, 1 compare), a
# point-in-box test (6 compares), and a query's 3 inverse directions.
BOX_OPS, POINT_BOX_OPS, QUERY_SETUP_OPS = 25, 6, 3
# FWD_OPS keys the tree replaces: the three loops over every sphere.
LOOP_KEYS = ("sphere", "shadow_sphere", "container")
# FWD_OPS keys of the node's O(1) forward that K4 rebuilds from sel.
K4_FWD_KEYS = ("node", "miss", "live", "light", "lit", "spawn", "refl")
SPHERE_ROOT_OPS = 35  # one sphere test with its real root (21 + 14)


def traversal_counts(lib, tables, bvh, state, spawn, seed, every=64):
    """The counting host build of K3 over a seeded 1-in-`every` sample of
    the state's ray slots, scaled to all of them: boxes and spheres tested
    by closest, blocked and contain (six numbers)."""
    import ctypes

    import torch

    rays = state.shape[1]
    k = max(rays // every, 1)
    gen = torch.Generator().manual_seed(seed)
    cols = torch.randperm(rays, generator=gen)[:k].sort().values
    st = state[:, cols.to(state.device)].cpu().contiguous()
    spheres, lights, bg = (t.cpu().contiguous() for t in tables)
    boxes, order = bvh.boxes.cpu().contiguous(), bvh.order.cpu().contiguous()
    em = torch.empty((3, k))
    kids = torch.empty((10, 2 * k))
    out = (ctypes.c_longlong * 6)()
    lib.raytpu_bvh_counts_host(out)  # reset
    lib.raytpu_wf_level_host(spheres.data_ptr(), spheres.shape[1], lights.data_ptr(),
                             lights.shape[1], bg.data_ptr(), boxes.data_ptr(),
                             order.data_ptr(), bvh.n_leaves, st.data_ptr(), k,
                             int(spawn), em.data_ptr(), kids.data_ptr(), None)
    lib.raytpu_bvh_counts_host(out)
    return [v * rays / k for v in out]


def bvh_level_ops(work, counts):
    """K3's operations through the tree: FWD_OPS without the sphere loops,
    plus the boxes and spheres the walk tested (traversal_counts)."""
    ops = sum(FWD_OPS[k] * work[k] for k in FWD_OPS
              if k != "sample" and k not in LOOP_KEYS)
    box_c, box_b, box_p, sph_c, sph_b, sph_p = counts
    ops += BOX_OPS * (box_c + box_b) + POINT_BOX_OPS * box_p
    ops += QUERY_SETUP_OPS * (work["node"] + work["shadow"])
    ops += FWD_OPS["sphere"] * sph_c + FWD_OPS["shadow_sphere"] * sph_b
    ops += FWD_OPS["container"] * sph_p
    return ops


def wavefront_contract(got, want, frac_tol=0.005, mean_tol=1e-4):
    """tests/test_wavefront.py:25-36: outliers at 1e-3*scale <= 0.5%, mean
    abs diff < 1e-4*scale; returns the stats."""
    g = np.asarray(got, np.float64).reshape(-1, 3)
    w = np.asarray(want, np.float64).reshape(-1, 3)
    check(g.shape == w.shape and np.isfinite(g).all(), "frame shape or finiteness")
    scale = max(float(np.abs(w).max()), 1e-30)
    d = np.abs(g - w)
    stats = dict(outliers=float((d.max(axis=1) > 1e-3 * scale).mean()),
                 mean_over_scale=float(d.mean() / scale), max_abs_err=float(d.max()))
    check(stats["outliers"] <= frac_tol, f"outlier fraction {stats['outliers']}")
    check(stats["mean_over_scale"] < mean_tol, f"mean/scale {stats['mean_over_scale']}")
    return stats


def device_breakdown(prof):
    """Device ms of a torch.profiler run by kernel group, or None when the
    profiler saw no device time."""
    from torch.autograd import DeviceType

    groups = {"wf_level": 0.0, "wf_compact": 0.0, "index_add_": 0.0, "rest": 0.0}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        name = e.key
        group = ("wf_level" if "wf_level_kernel" in name
                 else "wf_compact" if "wf_compact_kernel" in name or "wf_tail_kernel" in name
                 else "index_add_" if "index" in name.lower()
                 else "rest")
        groups[group] += us / 1e3
    return groups if sum(groups.values()) > 0 else None


def wavefront_phases(dev, count_lib):
    """Phases 10-12: the wavefront path (K3 and K5) at config 5.  Returns
    the two kernels' entries of the kernels JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import raytpu_torch.render as render
    from raytpu_torch import cli
    from raytpu_torch.config import BENCH_CONFIGS, RenderConfig
    from raytpu_torch.image import read_ppm, tone_map
    from raytpu_torch.kernels.trace_cuda import render_pixels_cuda, scene_tables
    from raytpu_torch.kernels.bvh import build_bvh
    from raytpu_torch.kernels.wavefront import (WF_COMPACT, WF_LEVEL,
                                                chunk_camera_state, compact,
                                                compact_torch,
                                                render_pixels_wavefront,
                                                wavefront_sizes, wf_level,
                                                wf_level_reference,
                                                wf_level_torch)
    from raytpu_torch.scene import default_scene, random_scene
    from raytpu_torch.utils.profiling import Timer

    c5 = BENCH_CONFIGS["config5"]
    s5 = random_scene(256, seed=3, device=dev)
    tables = scene_tables(s5)
    bvh = build_bvh(*tables[:2])
    first = dict(chunk_rays=render.WF_AUTO_CHUNK,
                 capacity_factor=render.WF_AUTO_LADDER[0])
    chunk, ws, cap, n_chunks = wavefront_sizes(c5, **first)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # Phase 10: K3 and K5 against their plain versions on chunk 0 of config
    # 5 (the ladder's first rung): level 0 and the first two compacted levels.
    state, pid = chunk_camera_state(c5, chunk, n_chunks, 0, c5.num_pixels,
                                    device=dev)
    k3_err = 0.0
    for level in range(3):
        em, ch = wf_level(s5, state, True, tables, bvh)
        torch.cuda.synchronize()
        pem, pch = wf_level_torch(s5, state, True)
        st = contract(em.T.cpu(), pem.T.cpu())
        k3_err = max(k3_err, st["max_abs_err"])
        off = float((~torch.isclose(ch, pch, rtol=1e-5, atol=1e-6).all(dim=0))
                    .float().mean())
        check(off <= 0.01, f"K3 level {level}: {off} of the children off rtol 1e-5")
        dead = (ch[6:9] == 0).all(dim=0)
        check(bool((ch[:, dead] == 0).all()), "K3 wrote a dead child that is not zero")
        keep = min(2 * state.shape[1], cap)
        got, want = compact(ch, pid, keep, ws), compact_torch(ch, pid, keep, ws)
        torch.cuda.synchronize()
        check(same(got, want), f"K5 level {level}: differs from compact_torch")
        n_alive = int(want[2]) + int(want[3])
        tight = n_alive // 2
        got_t = compact(ch, pid, tight, ws)
        torch.cuda.synchronize()
        check(same(got_t, compact_torch(ch, pid, tight, ws))
              and int(got_t[2]) == n_alive - tight > 0,
              f"K5 level {level}: the drop path differs from compact_torch")
        print(f"phase 10: config5 chunk 0 level {level}: {state.shape[1]} rays; "
              f"K3 emissions vs plain outliers {st['outliers']:.5f} mean/scale "
              f"{st['mean_over_scale']:.3e} max_abs_err {st['max_abs_err']:.3e}, "
              f"children off rtol 1e-5 {off:.5f}; K5 bit-identical at cap {keep} "
              f"({n_alive} live, {int(want[2])} dropped) and at cap {tight} "
              f"({n_alive - tight} dropped)")
        state, pid = got[0], got[1]
    print(f"phase 10: K5: {compact_edge_cases(dev, return_dst=False)}")

    # Phase 11: the slice's path, config 5 through the CLI.
    captured = []
    real = render.render_single

    def spy(scene, cfg, backend="auto", wf_opts=None, return_info=False,
            on_drop="warn"):
        img, info = real(scene, cfg, backend, wf_opts, True, on_drop)
        captured.append((scene, img, info))
        return (img, info) if return_info else img

    argv = ["--scene", "random", "--num-spheres", "256", "--seed", "3",
            "--width", str(c5.width), "--height", str(c5.height), "--max-depth",
            str(c5.max_depth), "--backend", "wavefront", "--strict-drops"]
    with tempfile.TemporaryDirectory() as tmp:
        ppm = os.path.join(tmp, "config5.ppm")
        render.render_single = spy
        try:
            WF_LEVEL.launches = WF_COMPACT.launches = 0
            t0 = time.perf_counter()
            rc = cli.main(argv + ["-o", ppm])
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t0
            l3, l5 = WF_LEVEL.launches, WF_COMPACT.launches
        finally:
            render.render_single = real
        check(rc == 0, f"cli.main returned {rc}")
        check(len(captured) == 1, f"the CLI rendered {len(captured)} frames")
        scene, img, info = captured[0]
        check(img.device.type == "cuda" and tuple(img.shape) == (1080, 1920, 3),
              f"frame {tuple(img.shape)} on {img.device}")
        check(info["dropped"] == 0, f"dropped {info['dropped']} after the ladder")
        img = img.cpu().numpy()
        check((read_ppm(ppm) == tone_map(img)).all(), "the PPM on disk is not the frame")
    opts = info["wf_opts"]
    attempts = render.WF_AUTO_LADDER.index(opts["capacity_factor"]) + 1
    n5 = wavefront_sizes(c5, opts["chunk_rays"], opts["capacity_factor"])[3]
    check(l3 == attempts * n5 * (c5.max_depth + 1)
          and l5 == attempts * n5 * c5.max_depth * 2,
          f"launches K3 {l3}, K5 {l5} for {attempts} rung(s) of {n5} chunks")
    dense = render_pixels_cuda(scene, c5).reshape(1080, 1920, 3).cpu().numpy()
    s11 = wavefront_contract(img, dense)
    print(f"phase 11: cli config5 1920x1080 d6 a3 N=256 --backend wavefront "
          f"--strict-drops ({cli_s:.2f} s incl. scene build, ladder and PPM): "
          f"wf_level launches {l3}, wf_compact launches {l5} ({n5} chunks, "
          f"{attempts} rung(s), options {opts}); dropped {info['dropped']}; vs "
          f"K1 outliers {s11['outliers']:.6f} mean/scale "
          f"{s11['mean_over_scale']:.3e} max_abs_err {s11['max_abs_err']:.3e}")

    # Phase 12: times.  The config-5 frame, wavefront and K1 in turns.
    timer = Timer(dev)
    wf = lambda: render_pixels_wavefront(s5, c5, **opts)  # noqa: E731
    k1 = lambda: render_pixels_cuda(s5, c5)  # noqa: E731
    wf(), k1()
    for _ in range(3):
        with timer.section("k1"):
            k1()
        with timer.section("wf"):
            wf()
    k1_ms, wf_ms = median_ms(timer, "k1"), median_ms(timer, "wf")
    print(f"phase 12: config5 frame: wavefront {wf_ms:.3f} ms "
          f"({c5.rays_per_frame / wf_ms / 1e3:.2f} camera Mrays/s), K1 "
          f"{k1_ms:.3f} ms ({c5.rays_per_frame / k1_ms / 1e3:.2f})")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ms_prof, _ = events_ms(wf, reps=1, warmup=0)
    groups = device_breakdown(prof)
    if groups is None:
        print("phase 12: config5 wavefront profile: no device time seen by "
              "torch.profiler (not measured)")
    else:
        busy = sum(groups.values())
        print(f"phase 12: config5 wavefront profile ({ms_prof:.3f} ms frame "
              f"under the profiler; device busy {busy:.3f} ms, idle share "
              f"{max(0.0, 1 - busy / ms_prof):.4f}): "
              + ", ".join(f"{k} {v:.3f} ms ({v / busy:.3%})" for k, v in groups.items()))

    for chunk_rays in (1 << 18, 1 << 19, 1 << 20, 1 << 21, 1 << 22, 1 << 23):
        for factor in (0.875, 1.0, 1.25):
            ms, (_, i) = events_ms(lambda: render_pixels_wavefront(
                s5, c5, chunk_rays=chunk_rays, capacity_factor=factor,
                return_info=True), reps=2)
            ch_, _, cap_, n_ = wavefront_sizes(c5, chunk_rays, factor)
            print(f"phase 12: sweep config5 chunk_rays {chunk_rays} (chunk "
                  f"{ch_}, {n_} chunks) x capacity {factor} (cap {cap_}): "
                  f"{ms:.3f} ms, dropped {int(i['dropped'])}")

    # The "auto" crossover cells, wavefront against K1 at 640x480 3x3:
    # (spheres, depth) around render._WF_MIN_WORK.
    cells = [(3, 4), (16, 4), (64, 2), (32, 4), (128, 2), (16, 6), (64, 4),
             (256, 2), (64, 6), (256, 4)]
    for n_spheres, depth in cells:
        sc = (default_scene(device=dev) if n_spheres == 3
              else random_scene(n_spheres, seed=3, device=dev))
        label = (f"{'default' if n_spheres == 3 else 'random'}({n_spheres}) "
                 f"640x480 d{depth}")
        cfg = RenderConfig(width=640, height=480, max_depth=depth)
        _, i = real(sc, cfg, "wavefront", return_info=True, on_drop="ignore")
        timer = Timer(dev)
        for _ in range(4):
            with timer.section("k1"):
                render_pixels_cuda(sc, cfg)
            with timer.section("wf"):
                render_pixels_wavefront(sc, cfg, **i["wf_opts"])
        k, w = (float(np.median(timer.times()[n][1:])) * 1e3 for n in ("k1", "wf"))
        auto = render.resolve_backend("auto", sc, cfg)
        print(f"phase 12: crossover {label}: N*2^d {sc.spheres.count * 2 ** depth}; "
              f"K1 {k:.3f} ms, wavefront {w:.3f} ms ({w / k:.3f}x; dropped "
              f"{i['dropped']} at {i['wf_opts']}); auto picks {auto}")

    # A host read of each compaction's kept count (what launching the next
    # level over the live rays only would need): the frame with that sync
    # added, against the frame as it runs, in turns.
    import raytpu_torch.kernels.wavefront as wavefront

    def synced(*args):
        out = compact(*args)
        int(out[3])
        return out

    timer = Timer(dev)
    for rep in range(4):
        for mode in ("static", "synced"):
            wavefront.compact = synced if mode == "synced" else compact
            try:
                with timer.section(mode):
                    wf()
            finally:
                wavefront.compact = compact
    st_ms, sy_ms = (float(np.median(timer.times()[m][1:])) * 1e3
                    for m in ("static", "synced"))
    print(f"phase 12: config5 frame with a host read of every kept count: "
          f"{sy_ms:.3f} ms against {st_ms:.3f} ms without")

    # K3 and K5 alone on chunk 0 of config 5, every level: K3 through the
    # tree against its brute-force reference instance in turns (ref, new,
    # new, ref, twice), bit for bit (emissions, children and, written by
    # both, sel); K5 (median of 3 after 1 warm-up); the plain versions (one
    # run) on the same inputs; the bounds of that work.  K3's operations:
    # FWD_OPS over the plain version's masks without the camera's
    # "sample", the sphere loops replaced by the boxes and spheres the
    # counting host build tests on a 1-in-64 sample (bvh_level_ops); the
    # reference algorithm's bound keeps the loops.  K3's bytes per launch:
    # the scene tables and the tree read once; 10 fields read per live ray
    # slot and the 3 intensities per dead one; 3 emissions and, on a
    # spawning level, 20 child fields written per slot.  K5's bytes: the 3
    # intensities of every child, the other 7 fields of the kept ones, the
    # parents' pids and 11 words per output slot.
    state, pid = chunk_camera_state(c5, chunk, n_chunks, 0, c5.num_pixels,
                                    device=dev)
    k3_ms = k3_ref_ms = k3_plain = k3_live_ms = k5_ms = k5_plain = 0.0
    k3_ops = k3_ref_ops = k3_bytes = k5_bytes = 0
    for level in range(c5.max_depth + 1):
        spawn = level < c5.max_depth
        rays = state.shape[1]
        with_sel = (wf_level(s5, state, spawn, tables, bvh, return_sel=True),
                    wf_level_reference(s5, state, spawn, tables, return_sel=True))
        torch.cuda.synchronize()
        check(all(same_bits(a, b) for a, b in zip(*with_sel)),
              f"K3 level {level}: differs from its brute-force reference "
              f"instance (emissions, children or sel)")
        ref_ms, ms, ref_out, (em, ch) = turns(
            lambda: wf_level_reference(s5, state, spawn, tables),
            lambda: wf_level(s5, state, spawn, tables, bvh))
        check(all(same_bits(a, b) for a, b in zip(ref_out, (em, ch))),
              f"K3 level {level}: differs from its reference without sel")
        # The same level launched over its live prefix only (the kept rays
        # lead the state): what the dead slots cost K3.
        live_state = state[:, :int((state[6:9] != 0).any(dim=0).sum())].contiguous()
        live_ms, _ = events_ms(lambda: wf_level(s5, live_state, spawn, tables, bvh))
        k3_live_ms += live_ms
        pms, _ = events_ms(lambda: wf_level_torch(s5, state, spawn), reps=1, warmup=0)
        work = wavefront_level_work(s5, state, spawn)
        ref_ops = sum(FWD_OPS[k] * work[k] for k in FWD_OPS if k != "sample")
        counts = traversal_counts(count_lib, tables, bvh, state, spawn, seed=level)
        ops = bvh_level_ops(work, counts)
        k3_ms, k3_ref_ms, k3_plain = k3_ms + ms, k3_ref_ms + ref_ms, k3_plain + pms
        k3_ops, k3_ref_ops = k3_ops + ops, k3_ref_ops + ref_ops
        live = work["node"]
        k3_bytes += 4 * (sum(t.numel() for t in tables) + bvh.boxes.numel()
                         + bvh.order.numel() + 10 * live + 3 * (rays - live)
                         + rays * (3 + (20 if spawn else 0)))
        line = (f"phase 12: config5 chunk 0 level {level}: {rays} ray slots, "
                f"{work['node']} live; K3 {ms:.3f} ms against its reference "
                f"{ref_ms:.3f} ms ({ref_ms / ms:.2f}x), bit-identical with sel "
                f"({live_ms:.3f} ms over the live prefix only), plain {pms:.3f} "
                f"ms, {ops / 1e9:.4f} GFLOP through the tree ({ref_ops / 1e9:.4f} "
                f"brute force; per live node {counts[0] / max(work['node'], 1):.1f} "
                f"boxes and {counts[3] / max(work['node'], 1):.1f} spheres for the "
                f"closest hit, per shadow ray {counts[1] / max(work['shadow'], 1):.1f} "
                f"and {counts[4] / max(work['shadow'], 1):.1f})")
        if spawn:
            keep = min(2 * rays, cap)
            cms, out = events_ms(lambda: compact(ch, pid, keep, ws))
            cpms, _ = events_ms(lambda: compact_torch(ch, pid, keep, ws), reps=1,
                                warmup=0)
            kept = int(out[3])
            k5_ms, k5_plain = k5_ms + cms, k5_plain + cpms
            k5_bytes += 12 * 2 * rays + 28 * kept + 4 * rays + 44 * keep
            line += f"; K5 {cms:.3f} ms, plain {cpms:.3f} ms, {kept} kept"
            state, pid = out[0], out[1]
        print(line)

    # K3 against its reference instance outside config 5, in turns and bit
    # for bit at every level of one 640x480 d4 3x3 frame (one chunk): the
    # smallest crossover cell's scene, and 3000 spheres, whose tree does not
    # fit shared memory beside the scene and is read through the read-only
    # cache.
    other = {}
    cfg = RenderConfig(width=640, height=480, max_depth=4)
    for label, sc in (("default(3)", default_scene(device=dev)),
                      ("random(3000)", random_scene(3000, seed=3, device=dev))):
        tb = scene_tables(sc)
        tree = build_bvh(*tb[:2])
        ch_, ws_, cap_, n_ = wavefront_sizes(cfg, **first)
        st, pd = chunk_camera_state(cfg, ch_, n_, 0, cfg.num_pixels, device=dev)
        new_t = ref_t = 0.0
        for level in range(cfg.max_depth + 1):
            spawn = level < cfg.max_depth
            check(all(same_bits(a, b) for a, b in zip(
                wf_level(sc, st, spawn, tb, tree, return_sel=True),
                wf_level_reference(sc, st, spawn, tb, return_sel=True))),
                f"K3 {label} level {level}: differs from its reference instance")
            ref_ms, ms, ref_out, (em, ch) = turns(
                lambda: wf_level_reference(sc, st, spawn, tb),
                lambda: wf_level(sc, st, spawn, tb, tree))
            check(all(same_bits(a, b) for a, b in zip(ref_out, (em, ch))),
                  f"K3 {label} level {level}: differs from its reference without sel")
            new_t, ref_t = new_t + ms, ref_t + ref_ms
            if spawn:
                st, pd = compact(ch, pd, min(2 * st.shape[1], cap_), ws_)[:2]
        other[f"{label} 640x480 d4"] = {"ms": new_t, "ref_ms": ref_t}
        print(f"phase 12: {label} 640x480 d4 a3 chunk 0 ({ch_} camera rays), "
              f"{cfg.max_depth + 1} levels: K3 {new_t:.3f} ms against its "
              f"reference {ref_t:.3f} ms ({ref_t / new_t:.2f}x), bit-identical "
              f"with sel at every level")

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"

    k3_bound, k5_bound = bound(k3_ops, k3_bytes), bound(0, k5_bytes)
    k3_ref_bound = bound(k3_ref_ops, k3_bytes)
    print(f"phase 12: config5 chunk 0, {c5.max_depth + 1} levels: K3 {k3_ms:.3f} ms "
          f"against its reference {k3_ref_ms:.3f} ms ({k3_ref_ms / k3_ms:.2f}x; "
          f"{k3_live_ms:.3f} ms over the live prefixes; plain {k3_plain:.3f} ms), "
          f"bound {k3_bound[0]:.4f} ms by {k3_bound[1]} "
          f"({k3_ops / 1e9:.3f} GFLOP at 67 TFLOP/s, {k3_bytes / 1e6:.3f} MB at "
          f"3.35 TB/s), the reference algorithm's bound {k3_ref_bound[0]:.4f} ms "
          f"({k3_ref_ops / 1e9:.3f} GFLOP); K5 {k5_ms:.3f} ms (plain "
          f"{k5_plain:.3f} ms), bound {k5_bound[0]:.4f} ms by bytes "
          f"({k5_bytes / 1e6:.3f} MB)")
    work_note = f"config5 chunk 0 ({chunk} camera rays), all {c5.max_depth + 1} levels"
    k3 = {"launches": l3, "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain,
          "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "ref_ms": k3_ref_ms,
          "ref_bound_ms": k3_ref_bound[0], "ref_bound_by": k3_ref_bound[1],
          "work": work_note, "frame_ms": wf_ms, "ref_other_scenes": other}
    k5 = {"launches": l5, "max_abs_err": 0.0, "ms": k5_ms, "plain_ms": k5_plain,
          "bound_ms": k5_bound[0], "bound_by": k5_bound[1], "work": work_note}
    return k3, k5, img


def seeded_level_cotangents(scene, state, spawn, seed, tables):
    """Seeded cotangents of one level on the card: emissions U(0.5, 1.5),
    children U(-1, 1) with a zero index row, both zeroed on the rays whose
    forwards (K3 against its plain version: emissions at 1e-5*scale,
    children at rtol 1e-5) differ.  Returns (em_ct, ch_ct, kept rays, K3's
    children, K3's selections)."""
    import torch

    from raytpu_torch.kernels.wavefront import wf_level, wf_level_torch

    em, kids, sel = wf_level(scene, state, spawn, tables, return_sel=True)
    pem, pkids = wf_level_torch(scene, state, spawn)
    bad = (em - pem).abs().amax(dim=0) > 1e-5 * pem.abs().max()
    if spawn:
        bad |= (~torch.isclose(kids, pkids, rtol=1e-5, atol=1e-6).all(dim=0)
                ).reshape(-1, 2).any(dim=1)
    gen = torch.Generator(device=state.device).manual_seed(seed)
    rays = state.shape[1]
    em_ct = 0.5 + torch.rand((3, rays), generator=gen, device=state.device)
    em_ct[:, bad] = 0.0
    ch_ct = None
    if spawn:
        ch_ct = 2 * torch.rand((10, 2 * rays), generator=gen, device=state.device) - 1
        ch_ct[9] = 0.0
        ch_ct[:, bad.repeat_interleave(2)] = 0.0
    return em_ct, ch_ct, ~bad, kids, sel


def level_grad_contract(scene, got, want, keep, state):
    """K4 against its plain version: exact zeros on dead rays and in the
    index row; per ray, each state cotangent of a kept ray within rtol 5e-2
    where |plain| > 1e-3 * its field's scale; each scene table leaf under
    grad_contract.  Returns (worst relative error per ray, per table, the
    largest absolute error)."""
    import torch

    from raytpu_torch.kernels.trace_cuda import grads_from_table

    dead = (state[6:9] == 0).all(dim=0)
    check(bool((got[0][:, dead] == 0).all()) and bool((got[0][9] == 0).all()),
          "K4: a dead ray's or the index row's cotangent is not an exact zero")
    a, w = got[0][:9][:, keep].double(), want[0][:9][:, keep].double()
    big = w.abs() > 1e-3 * w.abs().amax(dim=1, keepdim=True)
    rel = ((a - w).abs()[big] / w.abs()[big])
    worst_ray = float(rel.max()) if rel.numel() else 0.0
    check(worst_ray <= 5e-2, f"K4: {int((rel > 5e-2).sum())} state cotangents "
          f"off rtol 5e-2 (worst {worst_ray})")
    n, nl = scene.spheres.count, scene.lights.count
    tables = [grads_from_table(torch.cat([t.reshape(-1) for t in g[1:]]), n, nl)
              for g in (got, want)]
    worst_tbl, max_abs = grad_contract(*tables)
    return worst_ray, worst_tbl, max(max_abs, float((a - w).abs().max()))


def training_phases(dev):
    """Phases 13-15: the wavefront training path (K4 and K6) at config 5.
    Returns the two kernels' entries of the kernels JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import raytpu_torch.grad as grad
    import raytpu_torch.render as render
    from raytpu_torch.config import BENCH_CONFIGS, RenderConfig
    from raytpu_torch.examples import fit_scene as fit_example
    from raytpu_torch.kernels.trace_cuda import scene_tables
    from raytpu_torch.kernels.wavefront import (WF_COMPACT, WF_LEVEL,
                                                WF_LEVEL_BWD, WF_UNCOMPACT,
                                                chunk_camera_state, compact,
                                                compact_torch, uncompact,
                                                uncompact_torch,
                                                wavefront_sizes, wf_level,
                                                wf_level_bwd,
                                                wf_level_bwd_reference,
                                                wf_level_bwd_torch, sel_rows)
    from raytpu_torch.scene import (LEAF_NAMES, default_scene, random_scene,
                                    scene_from_leaves, scene_leaves)
    from raytpu_torch.utils.profiling import Timer

    kernels = (WF_LEVEL, WF_LEVEL_BWD, WF_COMPACT, WF_UNCOMPACT)
    c5 = BENCH_CONFIGS["config5"]
    s5 = random_scene(256, seed=3, device=dev)
    tables = scene_tables(s5)
    first = render._wf_auto_trials(None, train=True)[0]
    chunk, ws, cap, n_chunks = wavefront_sizes(c5, **first)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    # Phase 13: K4 and K6 against their plain versions on chunk 0.
    state, pid = chunk_camera_state(c5, chunk, n_chunks, 0, c5.num_pixels,
                                    device=dev)
    k4_err = k4_rel = 0.0
    for level in range(3):
        em_ct, ch_ct, keep, kids, sel = seeded_level_cotangents(s5, state, True,
                                                                level, tables)
        got = wf_level_bwd(s5, state, em_ct, ch_ct, True, tables, sel=sel)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = wf_level_bwd_torch(s5, state, em_ct, ch_ct, True)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        worst_ray, worst_tbl, max_abs = level_grad_contract(s5, got, want, keep, state)
        k4_err, k4_rel = max(k4_err, max_abs), max(k4_rel, worst_ray, worst_tbl)
        n_alive = int((kids[6:9] != 0).any(dim=0).sum())
        line = (f"phase 13: config5 chunk 0 level {level}: {state.shape[1]} rays, "
                f"cotangent zeroed on {int((~keep).sum())}; K4 vs plain "
                f"({plain_s:.1f} s): worst relative error per ray "
                f"{worst_ray:.3e}, per table {worst_tbl:.3e} (<= 5e-2), max abs "
                f"{max_abs:.3e}; dead rays exact zeros")
        for keep_n in (min(2 * state.shape[1], cap), n_alive // 2):
            out = compact(kids, pid, keep_n, ws, return_dst=True)
            check(same(out, compact_torch(kids, pid, keep_n, ws, return_dst=True)),
                  f"K5 with its destination index, level {level}: differs from plain")
            gen = torch.Generator(device=dev).manual_seed(100 + level)
            d = torch.randn((10, keep_n), generator=gen, device=dev)
            back = uncompact(d, out[4], keep_n)
            torch.cuda.synchronize()
            check(torch.equal(back, uncompact_torch(d, out[4], keep_n)),
                  f"K6 level {level} cap {keep_n}: differs from uncompact_torch")
            line += (f"; K6 bit-identical at cap {keep_n} ({int(out[2])} "
                     f"dropped)")
        print(line)
        state, pid = compact(kids, pid, min(2 * state.shape[1], cap), ws)[:2]
    print(f"phase 13: K5 with dst: {compact_edge_cases(dev, return_dst=True)}")

    # Phase 14: the slice's path, fit_scene(backend="wavefront") at config 5.
    truth = random_scene(256, seed=3, device=dev)
    start = fit_example.perturb(truth, geometry=False)
    with torch.no_grad():
        target = render.render_single(truth, c5, "wavefront").reshape(-1, 3)
    trainable = scene_from_leaves([n in ("spheres.matte", "lights.col")
                                   for n in LEAF_NAMES])
    calls = []
    real = grad.loss_and_grad_sharded

    def spy(scene, cfg, target_flat, **kw):  # fit_scene's every step
        out = real(scene, cfg, target_flat, **kw)
        calls.append((scene, out, kw["wf_opts"]))
        return out

    grad.loss_and_grad_sharded = spy
    try:
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        _, losses = grad.fit_scene(
            start, c5, target, steps=3, backend="wavefront", trainable=trainable,
            optimizer=lambda p: torch.optim.Adam(p, lr=2e-2, eps=1e-16))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        l3, l4, l5, l6 = (k.launches for k in kernels)
    finally:
        grad.loss_and_grad_sharded = real
    chunks = [wavefront_sizes(c5, kw["chunk_rays"], kw["capacity_factor"])[3]
              for _, _, kw in calls]
    levels = c5.max_depth + 1
    # A step of more than one chunk checkpoints each: its backward re-runs
    # the chunk's K3 and K5.
    fwd = sum(n * (2 if n > 1 else 1) for n in chunks)
    check((l3, l4, l5, l6) == (fwd * levels, sum(chunks) * levels,
                               fwd * (levels - 1) * 2,
                               sum(chunks) * (levels - 1)),
          f"launches K3 {l3} K4 {l4} K5 {l5} K6 {l6} for {len(calls)} steps of "
          f"{chunks} chunks")
    kept = [c for c in calls if c[1][2]["dropped"] == 0]
    check(len(kept) == 3, f"{len(calls) - len(kept)} of {len(calls)} steps dropped rays")
    check(all(np.isfinite(losses)) and losses[-1] <= losses[0],
          f"the fit's loss rose: {losses}")
    scene0, (loss_w, grads_w, info0), opts0 = kept[0]
    loss_k, grads_k = grad.loss_and_grad(scene0, c5, target, backend="cuda")
    rel_loss = abs(float(loss_w) - float(loss_k)) / abs(float(loss_k))
    check(rel_loss <= 1e-5, f"first loss {float(loss_w)} vs K1+K2 {float(loss_k)}")
    worst_leaf = 0.0
    for name, a, b in zip(LEAF_NAMES, scene_leaves(grads_w), scene_leaves(grads_k)):
        scale = max(float(b.abs().max()), 1e-30)
        frac = float((a - b).abs().max()) / scale
        check(np.isfinite(frac) and frac <= 2e-3, f"{name}: max |wf - K2| = {frac} x scale")
        worst_leaf = max(worst_leaf, frac)
    print(f"phase 14: fit_scene config5 1920x1080 d6 a3 N=256 backend=wavefront, "
          f"3 steps of matte + light colours ({fit_s:.2f} s, {len(calls)} calls at "
          f"{[kw for _, _, kw in calls][0]}): K3 {l3}, K4 {l4}, K5 {l5}, K6 {l6} "
          f"launches ({chunks} chunks); dropped 0; loss "
          + " -> ".join(f"{v:.6e}" for v in losses)
          + f"; first step vs K1+K2: loss rel {rel_loss:.2e} (<= 1e-5), worst "
          f"leaf max|diff|/scale {worst_leaf:.2e} (<= 2e-3)")
    for k in kernels:
        k.launches = 0
    c3 = BENCH_CONFIGS["config3"]
    fit = fit_example.main([
        "--width", str(c3.width), "--height", str(c3.height), "--depth",
        str(c3.max_depth), "--alias-factor", str(c3.alias_factor), "--mode",
        "geometry", "--steps", "3", "--backend", "wavefront"])
    torch.cuda.synchronize()
    check(WF_LEVEL_BWD.launches > 0 and WF_UNCOMPACT.launches > 0,
          "the example did not launch K4 and K6")
    check(len(fit["losses"]) == 3 and all(np.isfinite(fit["losses"])),
          f"example losses {fit['losses']}")
    print(f"phase 14: fit example config 3 --backend wavefront, 3 steps: K3 "
          f"{WF_LEVEL.launches}, K4 {WF_LEVEL_BWD.launches}, K5 "
          f"{WF_COMPACT.launches}, K6 {WF_UNCOMPACT.launches} launches; loss "
          f"{fit['start_loss']:.6e} -> " + " -> ".join(f"{v:.6e}" for v in fit["losses"]))

    # Phase 15: times.  The config-5 training step, wavefront and K1 + K2.
    timer = Timer(dev)
    wf = lambda: grad.loss_and_grad_wavefront(start, c5, target, **opts0)  # noqa: E731
    k2 = lambda: grad.loss_and_grad(start, c5, target, backend="cuda")  # noqa: E731
    wf(), k2()
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(3):
        with timer.section("k2"):
            k2()
        with timer.section("wf"):
            wf()
    peak = torch.cuda.max_memory_allocated(dev)
    k2_ms, wf_ms = median_ms(timer, "k2"), median_ms(timer, "wf")
    print(f"phase 15: config5 training step ({opts0}): wavefront {wf_ms:.3f} ms, "
          f"K1 + K2 {k2_ms:.3f} ms ({k2_ms / wf_ms:.2f}x); peak memory "
          f"{peak / 2**30:.2f} GiB (both)")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ms_prof, _ = events_ms(wf, reps=1, warmup=0)
    groups = dict.fromkeys(["K3 wf_level", "K5 wf_compact", "K4 wf_level_bwd",
                            "K6 wf_uncompact", "index_add_",
                            "index_add_ backward gather", "rest"], 0.0)
    from torch.autograd import DeviceType
    rest = {}
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        name, low = e.key, e.key.lower()
        group = ("K4 wf_level_bwd" if "wf_level_bwd_kernel" in name
                 else "K3 wf_level" if "wf_level_kernel" in name
                 else "K6 wf_uncompact" if "wf_uncompact_kernel" in name
                 else "K5 wf_compact" if "wf_compact_kernel" in name or "wf_tail_kernel" in name
                 else "index_add_ backward gather" if "indexselect" in low or "gather" in low
                 else "index_add_" if "index" in low
                 else "rest")
        groups[group] += us / 1e3
        if group == "rest":
            rest[name[:60]] = us / 1e3
    busy = sum(groups.values())
    if busy == 0:
        print("phase 15: config5 training step profile: no device time seen by "
              "torch.profiler (not measured)")
    else:
        print(f"phase 15: config5 training step profile ({ms_prof:.3f} ms under "
              f"the profiler; device busy {busy:.3f} ms, idle share "
              f"{max(0.0, 1 - busy / ms_prof):.4f}): "
              + ", ".join(f"{k} {v:.3f} ms ({v / busy:.2%})" for k, v in groups.items()))
        print("phase 15: the rest's largest: " + "; ".join(
            f"{k} {v:.3f} ms" for k, v in sorted(rest.items(), key=lambda kv: -kv[1])[:4]))
    for chunk_rays in (1 << 20, 1 << 21, 1 << 22):
        torch.cuda.reset_peak_memory_stats(dev)
        ms, (_, _, i) = events_ms(lambda: grad.loss_and_grad_wavefront(
            start, c5, target, chunk_rays=chunk_rays,
            capacity_factor=first["capacity_factor"], on_drop="ignore",
            return_info=True), reps=2)
        print(f"phase 15: sweep config5 training step chunk_rays {chunk_rays} "
              f"({wavefront_sizes(c5, chunk_rays, first['capacity_factor'])[3]} "
              f"chunks) x capacity {first['capacity_factor']}: {ms:.3f} ms, dropped "
              f"{i['dropped']}, peak {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")

    # The training crossover: the cells of phase 12, one training step each
    # way, in turns (median of the last 3 of 4); the N=3 d4 cell, config
    # 3's, read three times over, for its spread.
    cells = [(3, 4), (3, 4), (3, 4), (16, 4), (64, 2), (32, 4), (128, 2),
             (16, 6), (64, 4), (256, 2), (64, 6), (256, 4)]
    ratios = {}
    for n_spheres, depth in cells:
        sc = (default_scene(device=dev) if n_spheres == 3
              else random_scene(n_spheres, seed=3, device=dev))
        cfg = RenderConfig(width=640, height=480, max_depth=depth)
        tgt = torch.zeros((cfg.num_pixels, 3), device=dev)
        timer = Timer(dev)
        infos = []
        for _ in range(4):
            with timer.section("k2"):
                grad.loss_and_grad(sc, cfg, tgt, backend="cuda")
            with timer.section("wf"):
                infos.append(grad.loss_and_grad_wavefront(
                    sc, cfg, tgt, on_drop="ignore", return_info=True, **first)[2])
        k, w = (float(np.median(timer.times()[n][1:])) * 1e3 for n in ("k2", "wf"))
        ratios.setdefault((n_spheres, depth), []).append(w / k)
        auto = grad.resolve_train_backend("auto", sc, cfg)
        faster = "wavefront" if w < k else "cuda"
        print(f"phase 15: training crossover N={sc.spheres.count} 640x480 d{depth}: "
              f"N*d {sc.spheres.count * depth}; K1 + K2 {k:.3f} ms, wavefront "
              f"{w:.3f} ms ({w / k:.3f}x; dropped {infos[-1]['dropped']}); "
              f"training auto picks {auto}, the faster is {faster}")
    reads = ratios[(3, 4)]
    print(f"phase 15: training crossover N=3 d4 over {len(reads)} reads: wavefront / "
          f"(K1 + K2) {min(reads):.3f}-{max(reads):.3f}x")

    # K4 and K6 alone on chunk 0, every level: K4 from K3's sel against its
    # reference instance (re-running the brute-force queries) in turns (ref,
    # new, new, ref, twice), d_state bit for bit and the tables within 1e-5
    # x max |ref| (atomics' order); K6 (median of 3 after 1 warm-up); the
    # plain versions (one run) and, for K6, torch.zeros + index_copy_ on the
    # same columns; bounds of that work.  K4: the adjoint's operations and
    # the node's O(1) forward it rebuilds (K4_FWD_KEYS and one sphere root
    # per hit) over the plain version's masks; the reference algorithm's
    # bound adds the forward's sphere loops.  K4's bytes per launch: the
    # scene tables read and the gradient table written once; per live ray
    # slot 10 + 3 (+ 18 on a spawning level) floats and 2 + ceil(L/32) sel
    # words read, per dead slot its 3 intensities; the 10 state cotangents
    # written per slot where they are wanted (not at level 0, whose camera
    # state takes none).  K6: its int32 dst read per child, the 9
    # differentiable floats read per kept child and 10 written per child.
    # K5 on this path (with dst) and without it, both timed here; its bytes
    # as phase 12 counts them, plus the 4-byte dst written per child.
    state, pid = chunk_camera_state(c5, chunk, n_chunks, 0, c5.num_pixels,
                                    device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    k4_ms = k4_ref_ms = k4_plain = k6_ms = k6_plain = k6_lib = 0.0
    k5_ad_ms = k5_fwd_ms = 0.0
    k4_ops = k4_ref_ops = k4_bytes = k6_bytes = k5_ad_bytes = 0
    k4_tbl_err = 0.0
    for level in range(levels):
        spawn = level < c5.max_depth
        rays = state.shape[1]
        em_ct = 0.5 + torch.rand((3, rays), generator=gen, device=dev)
        ch_ct = (2 * torch.rand((10, 2 * rays), generator=gen, device=dev) - 1
                 if spawn else None)
        _, kids, sel = wf_level(s5, state, spawn, tables, return_sel=True)
        got = wf_level_bwd(s5, state, em_ct, ch_ct, spawn, tables, sel=sel)
        want = wf_level_bwd_reference(s5, state, em_ct, ch_ct, spawn, tables)
        torch.cuda.synchronize()
        check(same_bits(got[0], want[0]),
              f"K4 level {level}: d_state differs from its reference instance")
        for a, b in zip(got[1:], want[1:]):
            err = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
            check(err <= 1e-5, f"K4 level {level}: a table off its reference by "
                  f"{err} x max |ref|")
            k4_tbl_err = max(k4_tbl_err, err)
        need = level > 0
        ref_ms, ms, _, _ = turns(
            lambda: wf_level_bwd_reference(s5, state, em_ct, ch_ct, spawn, tables,
                                           need_state=need),
            lambda: wf_level_bwd(s5, state, em_ct, ch_ct, spawn, tables,
                                 need_state=need, sel=sel))
        pms, _ = events_ms(lambda: wf_level_bwd_torch(s5, state, em_ct, ch_ct, spawn),
                           reps=1, warmup=0)
        work = wavefront_level_work(s5, state, spawn)
        adj = sum(ADJ_OPS[k] * work[k] for k in ADJ_OPS)
        ops = (adj + sum(FWD_OPS[k] * work[k] for k in K4_FWD_KEYS)
               + SPHERE_ROOT_OPS * (work["node"] - work["miss"]))
        ref_ops = adj + sum(FWD_OPS[k] * work[k] for k in FWD_OPS if k != "sample")
        k4_ms, k4_ref_ms, k4_plain = k4_ms + ms, k4_ref_ms + ref_ms, k4_plain + pms
        k4_ops, k4_ref_ops = k4_ops + ops, k4_ref_ops + ref_ops
        live = work["node"]
        k4_bytes += 4 * (2 * sum(t.numel() for t in tables)
                         + live * (10 + 3 + (18 if spawn else 0)
                                   + sel_rows(s5.lights.count))
                         + 3 * (rays - live) + (10 * rays if need else 0))
        line = (f"phase 15: config5 chunk 0 level {level}: {rays} ray slots, "
                f"{work['node']} live; K4 {ms:.3f} ms against its reference "
                f"{ref_ms:.3f} ms ({ref_ms / ms:.2f}x), d_state bit-identical, "
                f"tables within {k4_tbl_err:.2e} x scale; plain {pms:.3f} ms, "
                f"{ops / 1e9:.4f} GFLOP ({ref_ops / 1e9:.4f} re-running the loops)")
        if spawn:
            keep_n = min(2 * rays, cap)
            n_kids = kids.shape[1]
            ad_ms, out = events_ms(lambda: compact(kids, pid, keep_n, ws, return_dst=True))
            fwd_ms, _ = events_ms(lambda: compact(kids, pid, keep_n, ws))
            k5_ad_ms, k5_fwd_ms = k5_ad_ms + ad_ms, k5_fwd_ms + fwd_ms
            kept = int(out[3])
            k5_ad_bytes += (12 * n_kids + 28 * kept + 4 * rays + 44 * keep_n
                            + 4 * n_kids)
            d = torch.randn((10, keep_n), generator=gen, device=dev)
            dst = out[4]
            cms, back = events_ms(lambda: uncompact(d, dst, keep_n))
            check(torch.equal(back, uncompact_torch(d, dst, keep_n)),
                  f"K6 level {level}: differs from uncompact_torch")
            cpms, _ = events_ms(lambda: uncompact_torch(d, dst, keep_n), reps=1, warmup=0)
            cols = torch.nonzero(dst >= 0).squeeze(1)

            def library():
                o = torch.zeros((10, n_kids), device=dev)
                return o.index_copy_(1, cols, d[:, :kept])

            lms, lib_out = events_ms(library)
            check(torch.equal(lib_out[:9], back[:9]),
                  f"level {level}: the library yardstick computes another function")
            k6_ms, k6_plain, k6_lib = k6_ms + cms, k6_plain + cpms, k6_lib + lms
            k6_bytes += 4 * (n_kids + 9 * kept + 10 * n_kids)
            line += (f"; K6 {cms:.3f} ms, plain {cpms:.3f} ms, zeros + index_copy_ "
                     f"{lms:.3f} ms, {kept} kept of {n_kids}; K5 with dst "
                     f"{ad_ms:.3f} ms, without {fwd_ms:.3f} ms")
            state, pid = out[0], out[1]
        print(line)

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"

    k4_bound, k6_bound = bound(k4_ops, k4_bytes), bound(0, k6_bytes)
    k4_ref_bound = bound(k4_ref_ops, k4_bytes)
    k5_ad_bound = bound(0, k5_ad_bytes)
    print(f"phase 15: config5 chunk 0, {levels} levels: K4 {k4_ms:.3f} ms against "
          f"its reference {k4_ref_ms:.3f} ms ({k4_ref_ms / k4_ms:.2f}x; plain "
          f"{k4_plain:.3f} ms), bound {k4_bound[0]:.4f} ms by {k4_bound[1]} "
          f"({k4_ops / 1e9:.3f} GFLOP at 67 TFLOP/s, {k4_bytes / 1e6:.3f} MB at "
          f"3.35 TB/s), the reference algorithm's bound {k4_ref_bound[0]:.4f} ms "
          f"({k4_ref_ops / 1e9:.3f} GFLOP); K6 {k6_ms:.3f} ms (plain {k6_plain:.3f} ms, zeros + "
          f"index_copy_ {k6_lib:.3f} ms), bound {k6_bound[0]:.4f} ms by bytes "
          f"({k6_bytes / 1e6:.3f} MB); K5 on this path with dst {k5_ad_ms:.3f} ms "
          f"(without {k5_fwd_ms:.3f} ms), bound {k5_ad_bound[0]:.4f} ms by bytes "
          f"({k5_ad_bytes / 1e6:.3f} MB)")
    check(k6_ms < k6_lib, f"K6 {k6_ms:.3f} ms is not faster than zeros + "
          f"index_copy_ {k6_lib:.3f} ms")
    work_note = f"config5 chunk 0 ({chunk} camera rays), all {levels} levels"
    k4 = {"launches": l4, "max_abs_err": k4_err, "max_rel_err": k4_rel,
          "ms": k4_ms, "plain_ms": k4_plain,
          "bound_ms": k4_bound[0], "bound_by": k4_bound[1], "ref_ms": k4_ref_ms,
          "ref_bound_ms": k4_ref_bound[0], "ref_bound_by": k4_ref_bound[1],
          "ref_table_err": k4_tbl_err, "work": work_note,
          "step_ms": wf_ms, "library_ms": None}
    k6 = {"launches": l6, "max_abs_err": 0.0, "ms": k6_ms, "plain_ms": k6_plain,
          "bound_ms": k6_bound[0], "bound_by": k6_bound[1], "work": work_note,
          "library_ms": k6_lib, "k5_with_dst_ms": k5_ad_ms,
          "k5_without_dst_ms": k5_fwd_ms, "k5_with_dst_bound_ms": k5_ad_bound[0],
          "step_peak_gib": peak / 2**30}
    return k4, k6


def fault_phase(dev):
    """Phase 16: inputs the dense kernels do not take, through the entry
    points a user calls, on the card.  Each case counts the launches of
    the kernels "auto" should reach, holds the frame to the plain version
    (the wavefront's contract for the wavefront, the forward contract for
    K1) and the gradient "auto" takes to the plain gradient under the
    gradient contract, on a seeded cotangent zeroed where the forwards
    differ; then a pixel subset's losses and gradient under "auto" against
    the same calls on the CPU.  Returns the lines' numbers."""
    import torch

    import raytpu_torch.grad as grad
    import raytpu_torch.render as render
    from raytpu_torch import cli
    from raytpu_torch.config import RenderConfig
    from raytpu_torch.image import read_ppm, tone_map
    from raytpu_torch.kernels.trace_cuda import (TRACE_BWD, TRACE_FWD,
                                                 grad_pixels_cuda,
                                                 grad_pixels_reference,
                                                 grad_pixels_torch,
                                                 render_pixels_cuda,
                                                 render_pixels_torch)
    from raytpu_torch.kernels.wavefront import (WF_COMPACT, WF_LEVEL,
                                                WF_LEVEL_BWD, WF_UNCOMPACT,
                                                render_pixels_wavefront)
    from raytpu_torch.scene import (default_scene, random_scene,
                                    scene_from_leaves, scene_leaves)

    kernels = (TRACE_FWD, TRACE_BWD, WF_LEVEL, WF_COMPACT, WF_LEVEL_BWD, WF_UNCOMPACT)

    def counts():
        return {k.name: k.launches for k in kernels}

    def reset():
        for k in kernels:
            k.launches = 0

    def seeded(shape, seed):
        rng = np.random.default_rng(seed)
        return torch.tensor(rng.uniform(0.5, 1.5, shape).astype(np.float32), device=dev)

    def auto_gradient(scene, cfg, backend, seed):
        """The gradient of sum(frame * g) by the path training "auto" took,
        g seeded and zeroed where its forward and the plain one differ,
        against the plain gradient."""
        plain = render_pixels_torch(scene, cfg)
        if backend == "wavefront":
            leaves = [t.detach().clone().requires_grad_(True) for t in scene_leaves(scene)]
            img = render_pixels_wavefront(
                scene_from_leaves(leaves), cfg, chunk_rays=render.WF_AUTO_CHUNK_TRAIN,
                capacity_factor=grad.WF_TRAIN_CAPACITY)
            g, zeroed = masked_cotangent(img.detach(), plain, seeded(tuple(plain.shape), seed))
            got = torch.autograd.grad(torch.sum(img * g), leaves, allow_unused=True)
            got = scene_from_leaves([torch.zeros_like(t) if d is None else d
                                     for t, d in zip(leaves, got)])
        else:
            g, zeroed = masked_cotangent(render_pixels_cuda(scene, cfg), plain,
                                         seeded(tuple(plain.shape), seed))
            got = grad_pixels_cuda(scene, cfg, g)
            ref_table_err(got, grad_pixels_reference(scene, cfg, g))
        return grad_contract(got, grad_pixels_torch(scene, cfg, g)), zeroed

    out = {}
    cases = [
        # 512-pixel chunks bound the plain version's 2^11-slot trees.
        ("default depth 10 64x48 a3", default_scene(device=dev),
         RenderConfig(width=64, height=48, max_depth=10, chunk_pixels=512),
         "wavefront"),
        ("random(5000) 64x48 d2 a1", random_scene(5000, seed=3, device=dev),
         RenderConfig(width=64, height=48, max_depth=2, alias_factor=1), "wavefront"),
        ("random(8, 1100 lights) 64x48 d2 a1",
         random_scene(8, num_lights=1100, seed=2, spread=5.0, device=dev),
         RenderConfig(width=64, height=48, max_depth=2, alias_factor=1), "wavefront"),
        ("random(64, 64 lights) 64x48 d2 a1",
         random_scene(64, num_lights=64, seed=3, device=dev),
         RenderConfig(width=64, height=48, max_depth=2, alias_factor=1), "cuda"),
    ]
    for label, scene, cfg, want in cases:
        t0 = time.perf_counter()
        check(render.resolve_backend("auto", scene, cfg) == want
              and grad.resolve_train_backend("auto", scene, cfg) == want,
              f"{label}: auto does not take {want}")
        reset()
        img = render.render_single(scene, cfg)
        torch.cuda.synchronize()
        c_fwd = counts()
        plain = render.render_single(scene, cfg, backend="torch")
        if want == "wavefront":
            check(c_fwd["wf_level"] > 0 and c_fwd["trace_fwd"] == 0,
                  f"{label}: render auto launched {c_fwd}")
            st = wavefront_contract(img.cpu().numpy(), plain.cpu().numpy())
        else:
            check(c_fwd["trace_fwd"] == 1, f"{label}: render auto launched {c_fwd}")
            st = contract(img.cpu().numpy(), plain.cpu().numpy())
        reset()
        target = torch.zeros((cfg.num_pixels, 3), device=dev)
        loss, grads = grad.loss_and_grad(scene, cfg, target)
        _, losses = grad.fit_scene(scene, cfg, target, steps=2)
        torch.cuda.synchronize()
        c_bwd = counts()
        check(c_bwd["wf_level_bwd" if want == "wavefront" else "trace_bwd"] >= 3,
              f"{label}: training auto launched {c_bwd}")
        check(np.isfinite(float(loss)) and all(np.isfinite(losses))
              and all(bool(torch.isfinite(t).all()) for t in scene_leaves(grads)),
              f"{label}: the loss or the gradient is not finite")
        (worst, max_abs), zeroed = auto_gradient(scene, cfg, want, seed=11)
        out[label] = dict(backend=want, outliers=st["outliers"], worst_rel=worst,
                          max_abs=max_abs)
        print(f"phase 16: {label}: auto takes {want} for the frame and the "
              f"training step ({time.perf_counter() - t0:.1f} s); frame vs plain "
              f"outliers {st['outliers']:.5f} mean/scale {st['mean_over_scale']:.3e}; "
              f"loss_and_grad and 2 fit_scene steps finite (launches "
              f"{ {k: v for k, v in c_bwd.items() if v} }); gradient vs plain: "
              f"cotangent zeroed on {zeroed} pixels, worst relative error "
              f"{worst:.3e} (<= 5e-2), max abs {max_abs:.3e}")

    # The CLI at depth 10 (render "auto", its default).
    with tempfile.TemporaryDirectory() as tmp:
        ppm = os.path.join(tmp, "deep.ppm")
        reset()
        rc = cli.main(["--width", "64", "--height", "48", "--max-depth", "10",
                       "-o", ppm])
        torch.cuda.synchronize()
        check(rc == 0 and WF_LEVEL.launches > 0 and TRACE_FWD.launches == 0,
              f"the CLI at depth 10: rc {rc}, launches {counts()}")
        frame = render.render_single(default_scene(device=dev),
                                     RenderConfig(width=64, height=48, max_depth=10))
        check((read_ppm(ppm) == tone_map(frame.cpu().numpy())).all(),
              "the CLI's PPM at depth 10 is not the frame")
    print(f"phase 16: cli 64x48 d10 (auto): wf_level launches {WF_LEVEL.launches}, "
          f"the PPM is the frame")

    # A pixel subset: image_loss and exposure_image_loss with a strided gid
    # under "auto" on a CUDA scene against the same calls on the CPU (the
    # losses), and the subset's differentiable render (what both losses
    # differentiate) on a seeded cotangent zeroed where the two devices'
    # forwards differ, under the gradient contract.
    cfg = RenderConfig(width=160, height=120, max_depth=2, alias_factor=2)
    rng = np.random.default_rng(12)
    target = rng.uniform(0.0, 1.0, (cfg.num_pixels, 3)).astype(np.float32)
    gid = np.arange(5, cfg.num_pixels, 7)
    reset()
    for fn in (grad.image_loss, grad.exposure_image_loss):
        lc, lp = (float(fn(default_scene(device=d), cfg, torch.tensor(target, device=d),
                           gid=torch.tensor(gid, device=d)))
                  for d in (dev, torch.device("cpu")))
        rel = abs(lc - lp) / abs(lp)
        check(rel <= 1e-4, f"{fn.__name__} with a gid: {lc} on the card, {lp} on the CPU")
        print(f"phase 16: {fn.__name__} 160x120 d2 a2 with a strided gid "
              f"({gid.size} pixels) under auto on the card: loss rel {rel:.2e} "
              f"(<= 1e-4) against the CPU")
    check(all(k.launches == 0 for k in kernels), f"a gid launched {counts()}")
    renders = []
    for d in (dev, torch.device("cpu")):
        scene = default_scene(device=d)
        leaves = [t.detach().clone().requires_grad_(True) for t in scene_leaves(scene)]
        img = grad._render_ad(scene_from_leaves(leaves), cfg,
                              torch.tensor(gid, device=d), "auto")
        renders.append((leaves, img))
    (lc, ic), (lp, ip) = renders
    g, zeroed = masked_cotangent(ic.detach().cpu(), ip.detach(),
                                 seeded(tuple(ip.shape), 13).cpu())
    gc = torch.autograd.grad(torch.sum(ic * g.to(dev)), lc, allow_unused=True)
    gp = torch.autograd.grad(torch.sum(ip * g), lp, allow_unused=True)
    worst, _ = grad_contract(
        scene_from_leaves([torch.zeros_like(t) if d is None else d for t, d in zip(lc, gc)]),
        scene_from_leaves([torch.zeros_like(t) if d is None else d for t, d in zip(lp, gp)]))
    print(f"phase 16: the gid subset's gradient on the card against the CPU: "
          f"cotangent zeroed on {zeroed} of {gid.size} pixels, worst relative "
          f"error {worst:.3e} (<= 5e-2); no kernel launched")
    return out


def sharded_phase(dev, frame11, golden_ppm):
    """Phase 17: the sharded paths.  A 1-rank "nccl" group in this process
    renders config 5 through render_sharded and takes one
    loss_and_grad_sharded step; two "gloo" ranks sharing the card (the
    multiprocess demo's "card" suite) render config 3 through K1 and step
    config 3 through K1 + K2 and config 5 through the wavefront; torchrun
    runs the CLI's --sharded --interleave golden render.  Returns each
    kernel's launches over this phase's paths (the rank-0 worker's and this
    process's)."""
    import torch
    import torch.distributed as dist

    import raytpu_torch.render as render
    from raytpu_torch import grad
    from raytpu_torch.config import BENCH_CONFIGS
    from raytpu_torch.examples.fit_scene import perturb
    from raytpu_torch.kernels.trace_cuda import TRACE_BWD, TRACE_FWD
    from raytpu_torch.kernels.wavefront import (WF_COMPACT, WF_LEVEL,
                                                WF_LEVEL_BWD, WF_UNCOMPACT)
    from raytpu_torch.parallel.mesh import initialize_distributed, make_mesh
    from raytpu_torch.scene import random_scene, scene_leaves
    from raytpu_torch.tools import multiprocess_demo as demo

    kernels = (TRACE_FWD, TRACE_BWD, WF_LEVEL, WF_COMPACT, WF_LEVEL_BWD,
               WF_UNCOMPACT)
    launches = dict.fromkeys((k.name for k in kernels), 0)

    def counted(fn):
        for k in kernels:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        got = {k.name: k.launches for k in kernels}
        for name, n in got.items():
            launches[name] += n
        return out, got

    c5 = BENCH_CONFIGS["config5"]
    truth = random_scene(256, seed=3, device=dev)
    start = perturb(truth, geometry=False)
    target = torch.from_numpy(frame11).reshape(-1, 3).to(dev)
    first = render._wf_auto_trials(None, train=True)[0]
    with tempfile.TemporaryDirectory() as tmp:
        initialize_distributed("file://" + os.path.join(tmp, "rendezvous"), 1, 0,
                               backend="nccl")
        try:
            mesh = make_mesh(dev)
            check((mesh.size, mesh.backend) == (1, "nccl"), f"mesh {mesh}")
            (img, info), got = counted(lambda: render.render_sharded(
                truth, c5, mesh, "wavefront", return_info=True, on_drop="raise",
                interleave=True))
            check(info["dropped"] == 0, f"sharded config-5 frame dropped {info}")
            check(got["wf_level"] > 0 and got["wf_compact"] > 0,
                  f"the sharded render launched {got}")
            s17 = wavefront_contract(img.cpu().numpy(), frame11)
            (loss, grads, sinfo), got_step = counted(lambda: grad.loss_and_grad_sharded(
                start, c5, target, mesh, "wavefront", True, first,
                return_info=True))
            check(sinfo["dropped"] == 0, f"sharded config-5 step dropped {sinfo}")
            check(all(got_step[k] > 0 for k in ("wf_level", "wf_compact",
                                                 "wf_level_bwd", "wf_uncompact")),
                  f"the sharded step launched {got_step}")
            loss1, grads1 = grad.loss_and_grad_wavefront(start, c5, target, **first)
            rel = abs(float(loss) - float(loss1)) / abs(float(loss1))
            worst = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                        for a, b in zip(scene_leaves(grads), scene_leaves(grads1)))
            check(rel <= 1e-5 and worst <= 2e-3,
                  f"1-rank sharded step vs one device: loss rel {rel}, leaf {worst}")
            sharded_ms, _ = events_ms(lambda: grad.loss_and_grad_sharded(
                start, c5, target, mesh, "wavefront", True, first), reps=3)
            single_ms, _ = events_ms(lambda: grad.loss_and_grad_wavefront(
                start, c5, target, **first), reps=3)
        finally:
            dist.destroy_process_group()
    print(f"phase 17: 1-rank nccl group, config5 render_sharded(interleave) "
          f"wavefront: launches {got}; dropped 0; vs phase 11's frame outliers "
          f"{s17['outliers']:.6f} mean/scale {s17['mean_over_scale']:.3e}; "
          f"loss_and_grad_sharded step: launches {got_step}, dropped 0, loss rel "
          f"{rel:.2e}, worst leaf {worst:.2e} vs one device; step {sharded_ms:.3f} "
          f"ms against {single_ms:.3f} ms one device")

    torch.cuda.empty_cache()  # the two ranks share this card's memory
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        results = demo.spawn("card", procs=2, device=str(dev), dist_backend="gloo",
                             out_dir=tmp, timeout=480)
        spawn_s = time.perf_counter() - t0
    want = {"render": ("trace_fwd",), "grad_cuda": ("trace_fwd", "trace_bwd"),
            "grad_wavefront": ("wf_level", "wf_compact", "wf_level_bwd",
                               "wf_uncompact")}
    for case in demo.SUITES["card"]:
        sm = demo.case_summary(results, case)
        check(sm["ok"], f"2 gloo ranks: {case['name']}: {sm}")
        kind = "render" if case["kind"] == "render" else case["name"].rsplit("_", 1)[0]
        check(all(sm["launches"][k] > 0 for k in want[kind]),
              f"{case['name']} launched {sm['launches']}")
        for name, n in sm["launches"].items():
            launches[name] += n
        line = {k: v for k, v in sm.items() if k not in ("ok",)}
        print(f"phase 17: 2 gloo ranks on one card, {json.dumps(line)}")
    print(f"phase 17: the two ranks' run took {spawn_s:.1f} s (process start "
          f"included); two ranks time-slice one card, so no scaling is measured")

    with tempfile.TemporaryDirectory() as tmp:
        ppm = os.path.join(tmp, "golden_sharded.ppm")
        env = dict(os.environ, PYTHONPATH=ROOT)
        res = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "1", "-m", "raytpu_torch.cli", "--sharded",
             "--interleave", "--time", "-o", ppm], cwd=tmp, env=env,
            capture_output=True, text=True, timeout=300)
        check(res.returncode == 0, f"torchrun cli: {res.stdout}{res.stderr}")
        with open(ppm, "rb") as f:
            sharded = f.read()
    stats = json.loads([line for line in res.stdout.splitlines()
                        if line.startswith("{")][-1])
    check(sharded == golden_ppm, "the torchrun --sharded --interleave golden PPM "
          "differs from phase 6's")
    check((stats["ranks"], stats["interleave"], stats["dropped"]) == (1, True, 0),
          f"torchrun cli --time: {stats}")
    print(f"phase 17: torchrun --nproc-per-node 1 cli --sharded --interleave "
          f"--time golden 800x600 d5 a3 (nccl): PPM byte-identical to phase "
          f"6's ({len(sharded)} bytes); {stats['backend']} "
          f"{stats['seconds'] * 1e3:.3f} ms a frame, gather included")
    return launches


def oracle_stack_check(oracle):
    """The oracle's recursion: raytpu_oracle asks for kStackBase + cap x
    kStackPerLevel bytes of stack a thread.  The sample kernel's ptxas frame
    must fit kStackBase, and the frames of every device function it may
    call (trace() and whatever ptxas did not inline) one level's
    kStackPerLevel."""
    frames = {name: int(line.split(" bytes stack frame")[0].split()[-1])
              for name, line in _stack_frames(oracle.build_log)}
    base = oracle.function("raytpu_oracle_stack_base")()
    per_level = oracle.function("raytpu_oracle_stack_per_level")()
    sample = [v for k, v in frames.items() if "oracle_sample_kernel" in k]
    callees = {k: v for k, v in frames.items() if "_kernel" not in k}
    check(len(sample) == 1 and sample[0] <= base
          and any("5trace" in k for k in callees)
          and sum(callees.values()) <= per_level,
          f"oracle stack frames {frames} exceed {base} + cap x {per_level}")
    print(f"phase 2: oracle: the sample kernel's stack frame {sample[0]} <= "
          f"{base} bytes; its callees' {sum(callees.values())} <= {per_level} "
          f"bytes a level ({len(callees)} function(s))")


def oracle_host_build():
    """raytpu_torch/csrc/oracle.cu built by g++ as plain C++ (-O2
    -ffp-contract=off): raytpu_oracle_host, the oracle kernels' per-sample
    and per-pixel functions on the host.  Returns the bound function."""
    import ctypes

    from raytpu_torch.kernels.trace_cuda import BUILD_DIR, CSRC

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / "liboracle_host.so"
    res = subprocess.run(["g++", "-x", "c++", "-std=c++17", "-O2",
                          "-ffp-contract=off", "-shared", "-fPIC", "-o",
                          str(path), str(CSRC / "oracle.cu")],
                         capture_output=True, text=True)
    check(res.returncode == 0, f"g++ build of oracle.cu failed: {res.stderr}")
    fn = ctypes.CDLL(str(path)).raytpu_oracle_host
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    fn.argtypes = [p, i, p, i, p, i, i, f, f, f, i, i, i, i, i, ll, ll, p]
    fn.restype = None
    return fn


def oracle_frame_same(got, want):
    """(bit-identical with equal NaN masks, NaN channels of `got`)."""
    import torch

    got = got.detach().cpu().reshape(-1)
    want = want.detach().cpu().reshape(-1)
    nan = torch.isnan(want)
    same = bool(torch.equal(torch.isnan(got), nan) and torch.equal(
        got[~nan].view(torch.int32), want[~nan].view(torch.int32)))
    return same, int(torch.isnan(got).sum())


def oracle_phase(dev, host_fn):
    """Phase 18: the strict-semantics oracle.  The kernel against its plain
    version on the card and against its g++ host build under the
    experiments' masks; the CLI's --oracle as a user runs it (the 400x300
    strict golden byte for byte, the golden 800x600, cap 6 with double
    Fresnel), counting the kernel's launches; the builders' default device;
    the kernel and its plain version timed at 800x600."""
    import torch

    from raytpu_torch import cli
    from raytpu_torch.config import RenderConfig
    from raytpu_torch.image import read_ppm
    from raytpu_torch.kernels.trace_cuda import TRACE_FWD, scene_tables
    from raytpu_torch.native import ORACLE, render_native
    from raytpu_torch.oracle import render_oracle
    from raytpu_torch.render import render_single
    from raytpu_torch.scene import default_scene, random_scene

    cases = [("default 96x72 cap5", default_scene(bg_opacity=0.0, device=dev),
              RenderConfig(width=96, height=72), 5, False),
             ("default 64x48 cap6 double", default_scene(bg_opacity=0.0, device=dev),
              RenderConfig(width=64, height=48), 6, True),
             ("random24 48x32 a2 cap5", random_scene(24, seed=7, device=dev),
              RenderConfig(width=48, height=32, alias_factor=2), 5, False)]
    for label, scene, cfg, cap, double in cases:
        got = render_native(scene, cfg, cap=cap, fresnel_double=double)
        torch.cuda.synchronize()
        same, nans = oracle_frame_same(got, render_oracle(
            scene, cfg, cap=cap, fresnel_double=double))
        check(same, f"oracle kernel on {label}: differs from its plain version")
        print(f"phase 18: oracle {label}: bit-identical to the plain version "
              f"on the card, NaN masks equal ({nans} NaN channels)")
    scene, cfg = cases[2][1], cases[2][2]
    s, l, b = scene_tables(scene.to("cpu"))
    for fma, approx in ((0, 0), (1, 0), (0, 1)):
        want = torch.full((cfg.num_pixels, 3), float("nan"))
        host_fn(s.data_ptr(), scene.spheres.count, l.data_ptr(),
                scene.lights.count, b.data_ptr(), cfg.width, cfg.height,
                cfg.zoom, cfg.image_world_width, cfg.image_world_height,
                cfg.alias_factor, 5, 0, fma, approx, 0, cfg.num_pixels,
                want.data_ptr())
        got = render_native(scene, cfg, fma_mask=fma, approx_mask=approx)
        torch.cuda.synchronize()
        same, _ = oracle_frame_same(got, want)
        check(same, f"oracle kernel at fma_mask={fma} approx_mask={approx}: "
              f"differs from its host build")
    print("phase 18: oracle random24 48x32 a2 cap5: bit-identical to its g++ "
          "host build at mask 0, fma_mask=1 and approx_mask=1")

    with tempfile.TemporaryDirectory() as tmp:
        ppm = os.path.join(tmp, "strict.ppm")
        res = subprocess.run(
            [sys.executable, "-m", "raytpu_torch.cli", "--oracle", "--width",
             "400", "--height", "300", "-o", ppm], cwd=tmp,
            env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
            text=True, timeout=300)
        check(res.returncode == 0, f"cli --oracle: {res.stdout}{res.stderr}")
        golden = read_ppm(os.path.join(ROOT, "docs", "renders",
                                       "golden_400x300_strict.ppm"))
        check((read_ppm(ppm) == golden).all(), "python -m raytpu_torch.cli "
              "--oracle --width 400 --height 300 differs from "
              "docs/renders/golden_400x300_strict.ppm")
        print("phase 18: python -m raytpu_torch.cli --oracle --width 400 "
              "--height 300: byte-identical to docs/renders/"
              "golden_400x300_strict.ppm")
        launches = {}
        for label, flags, cap, double in (
                ("golden 800x600", [], 5, False),
                ("800x600 --oracle-cap 6 --fresnel-double",
                 ["--oracle-cap", "6", "--fresnel-double"], 6, True)):
            captured = []
            native_render = render_native

            def spy(*args, **kwargs):
                out = native_render(*args, **kwargs)
                captured.append(out)
                return out

            import raytpu_torch.native as native
            native.render_native = spy
            try:
                ORACLE.launches = 0
                rc = cli.main(["--oracle", *flags, "-o", ppm])
                torch.cuda.synchronize()
                launches[label] = ORACLE.launches
            finally:
                native.render_native = native_render
            check(rc == 0, f"cli --oracle {label}: returned {rc}")
            check(launches[label] == 1 and len(captured) == 1,
                  f"cli --oracle {label}: {launches[label]} oracle launches")
            img = captured[0]
            check(tuple(img.shape) == (600, 800, 3), f"oracle image {tuple(img.shape)}")
            plain = render_oracle(default_scene(bg_opacity=0.0, device=dev),
                                  RenderConfig(), cap=cap, fresnel_double=double)
            same, nans = oracle_frame_same(img, plain)
            plain_nans = int(torch.isnan(plain).sum())
            check(same and nans <= plain_nans, f"cli --oracle {label}: differs "
                  f"from the plain version ({nans} NaN channels, plain "
                  f"{plain_nans})")
            print(f"phase 18: cli --oracle {label}: oracle launches "
                  f"{launches[label]}; bit-identical to the plain version, NaN "
                  f"channels {nans} (plain {plain_nans})")

    check(default_scene().device.type == "cuda",
          "default_scene() did not land on the card")
    TRACE_FWD.launches = 0
    render_single(default_scene(), RenderConfig(width=64, height=48, max_depth=2,
                                                alias_factor=1))
    torch.cuda.synchronize()
    check(TRACE_FWD.launches == 1,
          f"render_single(default_scene()) launched K1 {TRACE_FWD.launches} times")
    print("phase 18: default_scene() lands on cuda; render_single on it "
          "launched trace_fwd once")

    scene, golden_cfg = default_scene(bg_opacity=0.0, device=dev), RenderConfig()
    times = {}
    for cap, double in ((5, False), (6, True)):
        k_ms, _ = events_ms(lambda: render_native(scene, golden_cfg, cap=cap,
                                                  fresnel_double=double), reps=5)
        p_ms, _ = events_ms(lambda: render_oracle(scene, golden_cfg, cap=cap,
                                                  fresnel_double=double),
                            reps=1, warmup=0)
        times[f"cap{cap}"] = (k_ms, p_ms)
        print(f"phase 18: oracle 800x600 a3 cap {cap}{' double' if double else ''}: "
              f"kernel {k_ms:.3f} ms (median of 5 after 1 warm-up), plain "
              f"version {p_ms:.3f} ms (one run), CUDA events")
    return launches, times

# The leaves the fit example fits in its geometry mode.
FITTED = ("spheres.pos", "spheres.radius", "spheres.matte", "lights.col")


def bench_phase(dev) -> dict:
    """Phase 20: raytpu's positional calls of render_timed and
    resolve_backend on a card scene, then raytpu_torch.bench in a fresh
    process.  Returns the bench's line."""
    import torch

    import raytpu_torch.render as render
    from raytpu_torch.bench import CONFIG3, DEADLINE_S, REPS
    from raytpu_torch.parallel import make_mesh
    from raytpu_torch.scene import default_scene

    scene = default_scene(device=dev)
    _, stats = render.render_timed(scene, CONFIG3, make_mesh(dev), 1, 3)
    backend = render.resolve_backend("auto", scene, CONFIG3)
    check(stats["backend"] == backend == "cuda",
          f"render_timed took {stats['backend']}, resolve_backend {backend}")
    check(stats["device"] == torch.cuda.get_device_name(dev) and stats["ranks"] == 1
          and stats["dropped"] == 0, f"render_timed's stats {stats}")
    print(f"phase 20: render_timed(scene, config3, mesh, 1, 3): backend "
          f"{stats['backend']} (resolve_backend(\"auto\", scene, cfg) too), "
          f"{stats['seconds'] * 1e3:.3f} ms, {stats['mrays_per_s']:.2f} camera Mrays/s")

    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "raytpu_torch.bench"], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
                         text=True, timeout=DEADLINE_S + 60)
    seconds = time.perf_counter() - t0
    lines = res.stdout.strip().splitlines()
    check(res.returncode == 0 and lines,
          f"the bench exited {res.returncode}: {res.stdout[-2000:]}{res.stderr[-4000:]}")
    line = json.loads(lines[-1])
    check(isinstance(line["value"], float) and line["value"] > 0,
          f"the bench's headline {line['value']}")
    check(line["fwd_bwd_backend"] == "cuda" and line["fwd_backend"] == "cuda",
          f"the bench's backends: forward {line['fwd_backend']}, step "
          f"{line['fwd_bwd_backend']}")
    check(line["config5_dropped_rays"] == 0,
          f"config 5 dropped {line['config5_dropped_rays']} rays")
    # Each timed key's launches (warm-up and runs): the path it timed.
    calls = REPS + 1
    dense = {"trace_fwd": calls, "trace_bwd": calls, "wf_level": 0, "wf_compact": 0}
    want = {"fwd": dict(dense, trace_bwd=0), "fwd_device": dict(dense, trace_bwd=0),
            "fwd_torch": dict.fromkeys(dense, 0), "fwd_bwd": dense,
            "step_device": dense, "golden_800x600_d5_fwd_bwd": dense}
    got = dict(line["launches"])
    c5 = got.pop("config5_1080p_d6_N256_wavefront")
    check(got == want, f"the bench's launches {got}, expected {want}")
    check(c5["wf_level"] > 0 and c5["wf_compact"] > 0 and c5["trace_fwd"] == 0
          and c5["trace_bwd"] == 0, f"config 5's launches {c5}")
    print(f"phase 20: python -m raytpu_torch.bench in a fresh process: exit 0 "
          f"in {seconds:.1f} s; {line['metric']} {line['value']:.2f}; launches "
          f"{json.dumps(line['launches'])}, config 5 {json.dumps(c5)}")
    return line


def step_times(dev) -> dict:
    """Phase 19's times at config 3 from the fit example's perturbed
    geometry against the true frame: loss_and_grad_packed and
    loss_and_grad(backend="cuda") in turns and pack_target alone (CUDA
    events, median of 5 after 1 warm-up), and both steps back to back (30
    calls: the device time where the host keeps ahead; the step is
    host-bound)."""
    from raytpu_torch.config import BENCH_CONFIGS
    from raytpu_torch.examples.fit_scene import perturb
    from raytpu_torch.grad import loss_and_grad, loss_and_grad_packed, pack_target
    from raytpu_torch.kernels.trace_cuda import render_pixels_cuda
    from raytpu_torch.scene import default_scene
    from raytpu_torch.utils.profiling import Timer

    c3 = BENCH_CONFIGS["config3"]
    truth = default_scene(device=dev)
    target = render_pixels_cuda(truth, c3)
    scene = perturb(truth, geometry=True)
    packed = pack_target(c3, target)
    fns = {"packed": lambda: loss_and_grad_packed(scene, c3, packed),
           "flat": lambda: loss_and_grad(scene, c3, target, backend="cuda"),
           "pack_target": lambda: pack_target(c3, target)}
    for fn in fns.values():
        fn()  # warm-up
    timer = Timer(dev)
    for i in range(5):
        for name in (("packed", "flat") if i % 2 == 0 else ("flat", "packed")):
            with timer.section(name):
                fns[name]()
        with timer.section("pack_target"):
            fns["pack_target"]()
    times = {name: median_ms(timer, name) for name in fns}
    for name in ("packed", "flat"):
        times[name + "_back_to_back"] = back_to_back_ms(fns[name])
    return times


def packed_phase(dev, smi):
    """Phase 19: raytpu's packed-tile training step on K1 + K2 and the
    culling blocks on the card.  (a) Three Adam steps of
    loss_and_grad_packed at config 3 from the fit example's perturbed
    geometry against the true frame, one K1 and one K2 launch a step, each
    step held against loss_and_grad(backend="cuda") on the same scene;
    (b) the golden frame's tiles (469, the last with 256 tail lanes):
    the tail equal to pixel P-1, two offset/count blocks whose lane j is
    pixel min(offset + j, P-1), and the gradient of a plain sum equal to
    the flat output's; (c) step_times in this process and in a fresh
    one; (d) tile_bounds and beam_live_mask on
    config-5 chunk 0's camera rays in 1024-ray tiles, card against CPU bit
    for bit and conservative against the eager intersection.  Returns the
    K1 and K2 launches of (a) and the phase's numbers."""
    import torch

    import raytpu_torch.render as render
    from raytpu_torch.config import BENCH_CONFIGS
    from raytpu_torch.examples.fit_scene import perturb
    from raytpu_torch.grad import (_value_and_grad, loss_and_grad,
                                   loss_and_grad_packed, pack_target)
    from raytpu_torch.kernels import culling
    from raytpu_torch.kernels.trace_cuda import (TILE_PIXELS, TILE_ROWS,
                                                 TRACE_BWD, TRACE_FWD,
                                                 render_pixels_cuda,
                                                 render_pixels_cuda_ad,
                                                 render_tiles_cuda_ad)
    from raytpu_torch.kernels.wavefront import chunk_camera_state, wavefront_sizes
    from raytpu_torch.ops.geometry import ray_sphere_t
    from raytpu_torch.scene import (LEAF_NAMES, default_scene, random_scene,
                                    scene_from_leaves, scene_leaves)

    t_phase = time.perf_counter()
    out = {}
    # (a) Config 3: the packed step as a fit takes it, counted alone.
    c3 = BENCH_CONFIGS["config3"]
    check(c3.num_pixels % TILE_PIXELS == 0, "config 3 is not whole tiles")
    truth = default_scene(device=dev)
    target = render_pixels_cuda(truth, c3)
    params = [t.detach().clone().requires_grad_(True)
              for t in scene_leaves(perturb(truth, geometry=True))]
    opt = torch.optim.Adam(params, lr=1e-2, eps=1e-16)  # the fit example's
    packed = pack_target(c3, target)
    steps = []
    TRACE_FWD.launches = TRACE_BWD.launches = 0
    for _ in range(3):
        scene = scene_from_leaves([p.detach().clone() for p in params])
        loss, grads = loss_and_grad_packed(scene, c3, packed)
        steps.append((scene, loss, grads))
        for p, g, name in zip(params, scene_leaves(grads), LEAF_NAMES):
            p.grad = g if name in FITTED else torch.zeros_like(g)
        opt.step()
    torch.cuda.synchronize()
    launches = (TRACE_FWD.launches, TRACE_BWD.launches)
    check(launches == (3, 3), f"3 packed steps launched K1 and K2 {launches} times")
    worst_loss = worst_leaf = 0.0
    for i, (scene, loss, grads) in enumerate(steps):
        flat_loss, flat_grads = loss_and_grad(scene, c3, target, backend="cuda")
        rel = abs(float(loss) / float(flat_loss) - 1.0)
        check(np.isfinite(float(loss)) and rel <= 1e-6,
              f"packed step {i}: loss {float(loss)!r} against the flat "
              f"{float(flat_loss)!r} (rtol 1e-6)")
        err = ref_table_err(grads, flat_grads, what=f"the flat step {i}")
        worst_loss, worst_leaf = max(worst_loss, rel), max(worst_leaf, err)
    out.update(launches={"trace_fwd": launches[0], "trace_bwd": launches[1]},
               config3_losses=[float(s[1]) for s in steps],
               loss_rel_err=worst_loss, leaf_err=worst_leaf)
    print(f"phase 19: config3 packed step x3 (Adam, the fit example's leaves): "
          f"K1 launches {launches[0]}, K2 launches {launches[1]}; losses "
          + " -> ".join(f"{v:.6e}" for v in out["config3_losses"])
          + f"; against loss_and_grad(backend='cuda') on each step's scene: "
          f"loss rel err {worst_loss:.3e} (<= 1e-6), worst leaf "
          f"{worst_leaf:.3e} x max |leaf| (<= 1e-5)")

    # (b) The golden frame: 480,000 pixels in 469 tiles, 256 tail lanes.
    golden = BENCH_CONFIGS["golden"]
    p = golden.num_pixels
    tiles = -(-p // TILE_PIXELS)
    ds = default_scene(device=dev)
    with torch.no_grad():
        tiled = render_tiles_cuda_ad(ds, golden)
        flat = render_pixels_cuda(ds, golden)
    torch.cuda.synchronize()
    check(tuple(tiled.shape) == (3, tiles * TILE_ROWS, 128),
          f"golden tiles shape {tuple(tiled.shape)}")
    lanes = tiled.reshape(3, -1).T.contiguous()
    tail = tiles * TILE_PIXELS - p
    check(same_bits(lanes[:p], flat.contiguous()),
          "the golden tiles' real lanes differ from render_pixels_cuda")
    check(same_bits(lanes[p:], lanes[p - 1:p].expand(tail, 3).contiguous()),
          "the golden tiles' tail lanes are not pixel P-1")
    # Offset/count: lane j is pixel min(offset + j, P-1), as in the TPU
    # kernel; the second block runs past the frame's end.
    shards = ((1000, 150_000), (p - 1000, 500))
    for offset, count in shards:
        with torch.no_grad():
            got = render_tiles_cuda_ad(ds, golden, offset, count)
            want = render_pixels_cuda(ds, golden, offset, got[0].numel())
        check(same_bits(got.reshape(3, -1).T.contiguous(), want.contiguous()),
              f"tiles of pixels {offset}+{count}: a lane is not pixel "
              f"min(offset + j, P-1)")
    _, g_tiled = _value_and_grad(
        lambda s: torch.sum(render_tiles_cuda_ad(s, golden)), ds)
    _, g_flat = _value_and_grad(
        lambda s: torch.sum(render_pixels_cuda_ad(s, golden)), ds)
    out["golden_tail_leaf_err"] = ref_table_err(
        g_tiled, g_flat, what="the golden frame's flat sum-gradient")
    print(f"phase 19: golden {golden.width}x{golden.height} d{golden.max_depth} "
          f"a{golden.alias_factor} tiled: {tiles} tiles, {tail} tail "
          f"lanes equal to pixel P-1 bit for bit, real lanes bit-identical to "
          f"render_pixels_cuda; offset/count blocks {shards}: lane j bit-identical "
          f"to pixel min(offset + j, P-1); gradient of a plain sum over the tiles vs the "
          f"flat output: worst leaf {out['golden_tail_leaf_err']:.3e} x max "
          f"|leaf| (<= 1e-5)")

    # (c) Times, in this process and in a fresh one: host work late in
    # this script has read slower than in a fresh process (PERF.md §7).
    here = step_times(dev)
    res = subprocess.run(
        [sys.executable, "-c", "import json, torch, chip_smoke; print(json.dumps("
         "chip_smoke.step_times(torch.device('cuda:0'))))"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=300)
    check(res.returncode == 0, f"the fresh process's step times: {res.stderr}")
    fresh = json.loads(res.stdout.strip().splitlines()[-1])
    out["ms"] = dict(this_process=here, fresh_process=fresh)
    for label, t in (("this process", here), ("a fresh process", fresh)):
        print(f"phase 19: config3 step in {label}, median of 5 after 1 warm-up, "
              f"in turns: packed {t['packed']:.4f} ms, flat {t['flat']:.4f} ms; "
              f"pack_target alone {t['pack_target']:.4f} ms; back to back (30 "
              f"calls) packed {t['packed_back_to_back']:.4f} ms, flat "
              f"{t['flat_back_to_back']:.4f} ms | nvidia-smi: {smi}")

    # (d) Culling blocks on config 5's chunk 0 camera rays, 1024-ray tiles.
    c5 = BENCH_CONFIGS["config5"]
    scene5 = random_scene(256, seed=3, device=dev)
    pos, rad = scene5.spheres.pos, scene5.spheres.radius
    chunk, _, _, n_chunks = wavefront_sizes(c5, render.WF_AUTO_CHUNK,
                                            render.WF_AUTO_LADDER[0])
    tile = 1024
    check(chunk % tile == 0, f"chunk {chunk} is not whole {tile}-ray tiles")
    state, _ = chunk_camera_state(c5, chunk, n_chunks, 0, c5.num_pixels, device=dev)
    fields = [state[i] for i in range(6)]  # origin xyz, direction xyz
    bounds = culling.tile_bounds(fields, tile)
    live = culling.beam_live_mask(bounds, pos, rad)
    cpu_bounds = culling.tile_bounds([f.cpu() for f in fields], tile)
    cpu_live = culling.beam_live_mask(cpu_bounds, pos.cpu(), rad.cpu())
    torch.cuda.synchronize()
    for (lo, hi), (clo, chi) in zip(bounds, cpu_bounds):
        check(same_bits(lo.cpu(), clo) and same_bits(hi.cpu(), chi),
              "tile_bounds on the card differs from the CPU")
    check(torch.equal(live.cpu(), cpu_live), "beam_live_mask on the card "
          "differs from the CPU")
    hit = torch.zeros_like(live)
    rays = 32 * tile
    for r0 in range(0, chunk, rays):
        o, d = state[0:3, r0:r0 + rays].T, state[3:6, r0:r0 + rays].T
        _, found = ray_sphere_t(o, d, pos, rad)
        hit[r0 // tile:(r0 + rays) // tile] = found.reshape(
            -1, tile, scene5.spheres.count).any(dim=1)
    missed = int((hit & ~live).sum())
    check(missed == 0, f"beam_live_mask killed {missed} (tile, sphere) pairs a "
          f"ray of the tile hits")
    n_tiles = live.shape[0]
    out["culling"] = dict(tiles=n_tiles, live_share=float(live.float().mean()),
                          live_per_tile=float(live.sum(dim=1).float().mean()),
                          hit_per_tile=float(hit.sum(dim=1).float().mean()))
    print(f"phase 19: culling on config5 chunk 0 ({chunk} camera rays, "
          f"{n_tiles} tiles of {tile}): tile_bounds and beam_live_mask "
          f"bit-identical card vs CPU; conservative (every hit pair live); "
          f"live share {out['culling']['live_share']:.4f}, "
          f"{out['culling']['live_per_tile']:.2f} of 256 spheres live a tile "
          f"on average, {out['culling']['hit_per_tile']:.2f} hit")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"phase 19: done in {out['seconds']:.1f} s")
    return launches, out


def chunks_phase(dev, smi) -> dict:
    """Phase 21: the wavefront's chunk loop at config 5's scene
    (random_scene(256, seed=3), depth 6, 3x3): (a) the 1920x1080 frame at
    streams 1, 2 and 4 against streams=1's, timed in turns; (b) the
    1920x1080 training step, each chunk checkpointed, at streams 1 and 2
    against K1 + K2, timed in turns with its peak memory; (c) one
    7680x4320 training step against K1 + K2, with its time and peak.
    Returns each wavefront kernel's launches over the phase and its
    numbers."""
    import gc

    import torch
    from torch.profiler import ProfilerActivity, profile

    import raytpu_torch.grad as grad
    import raytpu_torch.render as render
    from raytpu_torch.config import BENCH_CONFIGS, RenderConfig
    from raytpu_torch.examples.fit_scene import perturb
    from raytpu_torch.kernels.trace_cuda import render_pixels_cuda
    from raytpu_torch.kernels.wavefront import (WF_COMPACT, WF_LEVEL,
                                                WF_LEVEL_BWD, WF_UNCOMPACT,
                                                render_pixels_wavefront,
                                                wavefront_sizes)
    from raytpu_torch.parallel.mesh import Mesh
    from raytpu_torch.scene import LEAF_NAMES, random_scene, scene_leaves

    kernels = (WF_LEVEL, WF_LEVEL_BWD, WF_COMPACT, WF_UNCOMPACT)
    for k in kernels:
        k.launches = 0
    c5 = BENCH_CONFIGS["config5"]
    truth = random_scene(256, seed=3, device=dev)
    gc.collect()
    torch.cuda.empty_cache()
    out = {"card": smi}
    gib = lambda b: b / 2**30  # noqa: E731

    def measured(fn):
        """(ms between CUDA events, peak GiB, fn()) of one call."""
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end), gib(torch.cuda.max_memory_allocated(dev)), res

    def reserved(fn):
        """The most memory the caching allocator held during one call of
        fn, in GiB, from an emptied cache: a side stream keeps blocks of its
        own, which max_memory_allocated does not show."""
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        fn()
        torch.cuda.synchronize(dev)
        return gib(torch.cuda.max_memory_reserved(dev))

    # (a) The forward frame at streams 1, 2 and 4.
    opts = dict(chunk_rays=render.WF_AUTO_CHUNK, capacity_factor=render.WF_AUTO_LADDER[0])
    n_chunks = wavefront_sizes(c5, **opts)[3]

    def frame(streams):
        return render_pixels_wavefront(truth, c5, return_info=True, streams=streams,
                                       **opts)

    ref, info = frame(1)
    again, _ = frame(1)
    torch.cuda.synchronize(dev)
    scale = float(ref.abs().max())
    self_diff = float((again - ref).abs().max())
    exact = self_diff == 0.0
    check(int(info["dropped"]) == 0, f"streams=1 dropped {int(info['dropped'])}")
    check(self_diff <= 1e-6 * scale, f"streams=1 against itself: {self_diff} "
          f"(scale {scale})")
    if not exact:
        print(f"phase 21: streams=1 differs from itself by {self_diff:.3e} "
              f"({self_diff / scale:.3e} x max |frame|; index_add_'s atomics): "
              f"each setting is held to 1e-6 x max |frame|, not bit for bit")
    diffs = {}
    for streams in (2, 4):
        img, i = frame(streams)
        torch.cuda.synchronize(dev)
        d = float((img - ref).abs().max())
        check(int(i["dropped"]) == 0, f"streams={streams} dropped {int(i['dropped'])}")
        check(d == 0.0 if exact else d <= 1e-6 * scale,
              f"streams={streams}: max |frame - streams=1's| = {d} (scale {scale})")
        diffs[streams] = d
    del img, again
    times = {s: [] for s in (1, 2, 4)}
    peaks = dict.fromkeys(times, 0.0)
    for s in times:
        frame(s)  # warm-up
    for _ in range(5):
        for s in times:
            ms, peak, _ = measured(lambda: frame(s))
            times[s].append(ms)
            peaks[s] = max(peaks[s], peak)
    fwd = {s: float(np.median(t)) for s, t in times.items()}
    rsv = {s: reserved(lambda: frame(s)) for s in times}
    # Kernels running at once on several streams sum to more device time
    # than the frame's wall time between events.
    overlap = {}
    for s in times:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ms, _ = events_ms(lambda: frame(s), reps=1, warmup=0)
        groups = device_breakdown(prof)
        overlap[s] = None if groups is None else sum(groups.values()) / ms
    out["forward"] = {"chunks": n_chunks, "opts": opts, "ms": fwd, "times_ms": times,
                      "peak_gib": peaks, "reserved_gib": rsv,
                      "kernel_time_over_wall": overlap,
                      "max_abs_vs_streams1": diffs, "streams1_self_diff": self_diff}
    print(f"phase 21 ({smi}): config5 1920x1080 d6 a3 frame, {n_chunks} chunks "
          f"at {opts}: streams 1 {fwd[1]:.3f} ms, 2 {fwd[2]:.3f} ms "
          f"({fwd[2] / fwd[1]:.3f}x), 4 {fwd[4]:.3f} ms ({fwd[4] / fwd[1]:.3f}x) "
          f"(median of 5 in turns after 1 warm-up); peak "
          + ", ".join(f"{s}: {p:.2f} GiB" for s, p in peaks.items())
          + " allocated, " + ", ".join(f"{s}: {p:.2f} GiB" for s, p in rsv.items())
          + " reserved; summed kernel time / wall time under torch.profiler "
          + ", ".join(f"{s}: " + ("not measured" if v is None else f"{v:.3f}")
                      for s, v in overlap.items())
          + f"; 0 dropped; {'bit-identical to' if exact else 'within 1e-6 x max of'} "
          f"streams=1's frame")

    # (b) The 1920x1080 training step against K1 + K2.
    start = perturb(truth, geometry=False)
    train = dict(chunk_rays=render.WF_AUTO_CHUNK_TRAIN,
                 capacity_factor=render.WF_AUTO_LADDER_TRAIN[0])
    one = Mesh(0, 1, dev)

    def held(cfg, target, steps):
        """Each wavefront step's loss and leaves against one K1 + K2 step
        (phase 14's bound); returns the worst loss's relative difference and
        the worst leaf's max |diff| / scale."""
        loss_k, grads_k = grad.loss_and_grad(start, cfg, target, backend="cuda")
        worst = worst_rel = 0.0
        for streams, (loss_w, grads_w, info) in steps.items():
            check(info["dropped"] == 0, f"streams={streams}: dropped {info['dropped']}")
            rel = abs(float(loss_w) - float(loss_k)) / abs(float(loss_k))
            worst_rel = max(worst_rel, rel)
            check(np.isfinite(float(loss_w)) and rel <= 1e-5,
                  f"{cfg.width}x{cfg.height} streams={streams}: loss {float(loss_w)} "
                  f"vs K1 + K2 {float(loss_k)}")
            for name, a, b in zip(LEAF_NAMES, scene_leaves(grads_w),
                                  scene_leaves(grads_k)):
                frac = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                check(np.isfinite(frac) and frac <= 2e-3,
                      f"{cfg.width}x{cfg.height} streams={streams} {name}: "
                      f"max |wf - K2| = {frac} x scale")
                worst = max(worst, frac)
        return worst_rel, worst

    def step(cfg, target, streams):
        return grad.loss_and_grad_sharded(start, cfg, target, one, "wavefront",
                                          wf_opts=dict(train, streams=streams),
                                          return_info=True)

    target = render_pixels_cuda(truth, c5)
    steps = {s: step(c5, target, s) for s in (1, 2)}
    rel, worst = held(c5, target, steps)
    del steps
    times = {1: [], 2: []}
    peaks = dict.fromkeys(times, 0.0)
    for _ in range(4):  # the first round is the warm-up
        for s in times:
            ms, peak, _ = measured(lambda: step(c5, target, s))
            times[s].append(ms)
            peaks[s] = max(peaks[s], peak)
    train_ms = {s: float(np.median(t[1:])) for s, t in times.items()}
    rsv = {s: reserved(lambda: step(c5, target, s)) for s in times}
    out["step_1080p"] = {"chunks": wavefront_sizes(c5, **train)[3], "opts": train,
                         "ms": train_ms, "times_ms": times, "peak_gib": peaks,
                         "reserved_gib": rsv,
                         "loss_rel": rel, "worst_leaf": worst}
    print(f"phase 21 ({smi}): config5 1920x1080 training step, "
          f"{out['step_1080p']['chunks']} checkpointed chunks at {train}: streams 1 "
          f"{train_ms[1]:.3f} ms, 2 {train_ms[2]:.3f} ms ({train_ms[2] / train_ms[1]:.3f}x) "
          f"(median of 3 in turns after 1 warm-up); peak {peaks[1]:.2f} and "
          f"{peaks[2]:.2f} GiB allocated, {rsv[1]:.2f} and {rsv[2]:.2f} GiB "
          f"reserved; against K1 + K2 loss rel {rel:.2e} (<= 1e-5), "
          f"worst leaf {worst:.2e} x scale (<= 2e-3); the step that kept every "
          f"chunk's residuals: 167.912 ms, 12.05 GiB (NVIDIA H100 80GB HBM3, "
          f"700.00 W)")
    del target

    # (c) One 7680x4320 training step.
    c8k = RenderConfig(width=7680, height=4320, max_depth=c5.max_depth,
                       alias_factor=c5.alias_factor)
    gc.collect()
    torch.cuda.empty_cache()
    target = render_pixels_cuda(truth, c8k)
    step(c8k, target, 1)  # warm-up
    held_gib = gib(torch.cuda.memory_allocated(dev))
    ms, peak, res = measured(lambda: step(c8k, target, 1))
    check(np.isfinite(float(res[0])) and res[2]["dropped"] == 0,
          f"8K step: loss {float(res[0])}, dropped {res[2]['dropped']}")
    check(peak <= 16.0, f"8K step peak {peak:.2f} GiB > 16")
    rel8, worst8 = held(c8k, target, {1: res})
    out["step_8k"] = {"chunks": wavefront_sizes(c8k, **train)[3], "ms": ms,
                      "peak_gib": peak, "held_before_gib": held_gib,
                      "loss_rel": rel8, "worst_leaf": worst8}
    print(f"phase 21 ({smi}): 7680x4320 d6 a3 training step, "
          f"{out['step_8k']['chunks']} checkpointed chunks: {ms:.3f} ms (one step "
          f"after 1 warm-up), peak {peak:.2f} GiB (<= 16; {held_gib:.2f} GiB held "
          f"before it); 0 dropped; against K1 + K2 loss rel {rel8:.2e} (<= 1e-5), "
          f"worst leaf {worst8:.2e} x scale (<= 2e-3)")
    del target, res
    torch.cuda.synchronize(dev)
    out["launches"] = {k.name: k.launches for k in kernels}
    check(all(n > 0 for n in out["launches"].values()),
          f"phase 21 launched {out['launches']}")
    return out


def tool_run(module: str, *args: str, timeout: int = 600):
    """`python -m raytpu_torch.tools.<module> args` in a fresh process:
    (its standard output, its standard error, seconds), or fail unless it
    exits 0."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", f"raytpu_torch.tools.{module}", *args],
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=timeout)
    check(res.returncode == 0, f"{module} {' '.join(args)} exited {res.returncode}: "
          f"{res.stdout[-3000:]}{res.stderr[-4000:]}")
    return res.stdout, res.stderr, time.perf_counter() - t0


def bench_all_launches(row: dict) -> dict:
    """The launches each key of a bench_all row must count: its calls (the
    first, the timed runs, and the wavefront's drop read) times one pass
    of its path."""
    from raytpu_torch.config import RenderConfig
    from raytpu_torch.grad import WF_TRAIN_CAPACITY
    from raytpu_torch.kernels.wavefront import wavefront_sizes
    from raytpu_torch.render import WF_AUTO_CHUNK_TRAIN
    from raytpu_torch.tools import bench_all
    from raytpu_torch.tools.common import KERNELS

    cfg = RenderConfig(width=row["width"], height=row["height"],
                       max_depth=row["depth"], alias_factor=row["alias"])
    d = cfg.max_depth
    none = dict.fromkeys(KERNELS, 0)
    dense = 1 + bench_all.REPS
    want = {"fwd": dict(none, trace_fwd=dense)}
    if "fwd_wavefront_ms" in row:
        chunks = wavefront_sizes(cfg, **bench_all.WAVEFRONT_OPTS)[3]
        calls = 2 + bench_all.REPS
        want["fwd_wavefront"] = dict(none, wf_level=calls * chunks * (d + 1),
                                     wf_compact=calls * chunks * d * 2)
    if "fwd_bwd_wavefront_ms" in row:
        chunks = wavefront_sizes(cfg, WF_AUTO_CHUNK_TRAIN, WF_TRAIN_CAPACITY)[3]
        calls = 2 + bench_all.STEP_REPS
        twice = 2 if chunks > 1 else 1  # each checkpointed chunk's forward re-runs
        want["fwd_bwd_wavefront"] = dict(
            none, wf_level=calls * twice * chunks * (d + 1),
            wf_compact=calls * twice * chunks * d * 2,
            wf_level_bwd=calls * chunks * (d + 1), wf_uncompact=calls * chunks * d)
    elif "fwd_bwd_ms" in row:
        want["fwd_bwd"] = dict(none, trace_fwd=dense, trace_bwd=dense)
    return want


def tools_phase() -> dict:
    """Phase 22: the measuring tools (raytpu_torch.tools), each in a fresh
    process: bench_all with config 5, step_bench at its defaults,
    shard_balance at config-5 size over 4 shards in blocks and interleaved
    (both at once: it times nothing), wf_breakdown at its defaults.  Each
    line's launches must be its path's.  Returns each kernel's launches
    over the tools and their lines."""
    from raytpu_torch.tools import step_bench, wf_breakdown
    from raytpu_torch.tools.common import KERNELS

    t_phase = time.perf_counter()
    lines = {}
    total = dict.fromkeys(KERNELS, 0)

    def add(launches):
        for key in launches.values():
            for name, n in key.items():
                total[name] += n

    out, _, seconds = tool_run("bench_all")
    rows = [json.loads(line) for line in out.strip().splitlines()]
    check([r["config"] for r in rows] == ["config1", "config2", "config3", "golden",
                                          "config5"],
          f"bench_all printed {[r.get('config') for r in rows]}")
    for r in rows:
        errors = {k: v for k, v in r.items() if k.endswith("_error")}
        check(not errors, f"bench_all {r['config']}: {errors}")
        wavefront = r["config"] == "config5"
        check(("fwd_wavefront_ms" in r) == ("fwd_bwd_wavefront_ms" in r) == wavefront
              and ("fwd_bwd_ms" in r) != wavefront,
              f"bench_all {r['config']} took the wrong paths: {sorted(r)}")
        want = bench_all_launches(r)
        check(r["launches"] == want,
              f"bench_all {r['config']}: launches {r['launches']}, expected {want}")
        add(r["launches"])
        print(f"phase 22: bench_all {json.dumps(r)}")
    lines["bench_all"] = rows
    print(f"phase 22: bench_all in a fresh process: exit 0 in {seconds:.1f} s; "
          f"every key's launches those of its path")

    out, _, seconds = tool_run("step_bench")
    line = json.loads(out.strip().splitlines()[-1])
    calls = 1 + step_bench.REPS
    none = dict.fromkeys(KERNELS, 0)
    step = dict(none, trace_fwd=calls, trace_bwd=calls)
    want = {"fwd": dict(none, trace_fwd=calls), "flat_step": step, "packed_step": step}
    check(line["launches"] == want, f"step_bench launches {line['launches']}, "
          f"expected {want}")
    check(min(line["fwd_ms"], line["flat_step_ms"], line["packed_step_ms"]) > 0,
          f"step_bench {line}")
    add(line["launches"])
    lines["step_bench"] = line
    print(f"phase 22: step_bench ({seconds:.1f} s) {json.dumps(line)}")

    shard_args = ["--width", "1920", "--height", "1080", "--alias", "3", "--shards", "4"]
    with ThreadPoolExecutor(2) as pool:
        runs = list(pool.map(lambda extra: tool_run("shard_balance", *shard_args, *extra),
                             ([], ["--interleave"])))
    for layout, (out, err, seconds) in zip(("blocks", "interleave"), runs):
        line = json.loads(out)
        # Each shard's live rays over its 6 levels: the busiest shard's sum
        # over the mean sum is the split's bound on a step's imbalance.
        shards = [json.loads(m.group(1)) for m in
                  re.finditer(r"^shard \d+: (\[.*\])$", err, re.MULTILINE)]
        check(len(shards) == 4, f"shard_balance {layout} printed {err[-2000:]}")
        sums = [sum(c) for c in shards]
        line["per_shard"] = shards
        line["sum_max_over_mean"] = max(sums) / (sum(sums) / len(sums))
        want = {"wf_level": 4 * 6, "wf_compact": 4 * 6 * 2}
        check(line["launches"] == dict(none, **want),
              f"shard_balance {layout} launches {line['launches']}")
        check(list(line["levels"]) == [f"L{i}" for i in range(1, 7)]
              and all(v["max"] > 0 and v["max_over_mean"] >= 1
                      for v in line["levels"].values()),
              f"shard_balance {layout}: {line['levels']}")
        add({layout: line["launches"]})
        lines[f"shard_balance_{layout}"] = line
        print(f"phase 22: shard_balance 1920x1080 d6 a3 N=256 4 shards {layout} "
              f"({seconds:.1f} s) {json.dumps(line)}")

    out, _, seconds = tool_run("wf_breakdown")
    line = json.loads(out.strip().splitlines()[-1])
    reps = 1 + wf_breakdown.REPS
    want = {"level_spawn": dict(none, wf_level=reps),
            "level_leaf": dict(none, wf_level=reps),
            "compact_2x": dict(none, wf_compact=2 * reps),
            "scatter": none, "scatter_eighth_live": none}
    check(line["launches"] == want, f"wf_breakdown launches {line['launches']}, "
          f"expected {want}")
    check(all(line[f"{k}_ms"] >= 0 and min(line[f"{k}_times_ms"]) > 0 for k in want),
          f"wf_breakdown {line}")
    add(line["launches"])
    lines["wf_breakdown"] = line
    print(f"phase 22: wf_breakdown ({seconds:.1f} s) {json.dumps(line)}")
    check(all(total[k] > 0 for k in KERNELS), f"the tools launched {total}")
    seconds = time.perf_counter() - t_phase
    print(f"phase 22: the tools launched {json.dumps(total)} in {seconds:.1f} s")
    return {"launches": total, "lines": lines, "seconds": seconds}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    import raytpu_torch.grad as grad
    import raytpu_torch.render as render
    from raytpu_torch import cli
    from raytpu_torch.config import BENCH_CONFIGS, RenderConfig
    from raytpu_torch.device import nvidia_smi_line
    from raytpu_torch.examples import fit_scene as fit_example
    from raytpu_torch.image import read_ppm, tone_map
    from raytpu_torch.kernels.trace_cuda import (TRACE_BWD, TRACE_FWD,
                                                 grad_pixels_cuda,
                                                 grad_pixels_reference,
                                                 grad_pixels_torch,
                                                 render_pixels_cuda,
                                                 render_pixels_reference,
                                                 render_pixels_torch,
                                                 scene_tables)
    from raytpu_torch.kernels.wavefront import (WF_COMPACT, WF_LEVEL,
                                                WF_LEVEL_BWD, WF_UNCOMPACT)
    from raytpu_torch.native import ORACLE
    from raytpu_torch.scene import (default_scene, random_scene,
                                    scene_from_leaves, scene_leaves,
                                    single_sphere_scene)
    from raytpu_torch.utils.profiling import Timer

    dev = torch.device("cuda:0")
    smi = nvidia_smi_line(dev)
    name = torch.cuda.get_device_name(dev)
    print(f"phase 1: device {name} | nvidia-smi: {smi}")

    # Phase 2: build, one nvcc per source, all at once (and the counting
    # host build of the level kernel for phase 12's bound, and the oracle's
    # host build for phase 18).
    kernels = (TRACE_FWD, TRACE_BWD, WF_LEVEL, WF_COMPACT, WF_LEVEL_BWD,
               WF_UNCOMPACT, ORACLE)
    for k in kernels:  # a cached library has no ptxas lines to hold
        if k.library_path().exists():
            k.library_path().unlink()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels) + 2) as pool:
        counting = pool.submit(build_counting_host)
        oracle_host = pool.submit(oracle_host_build)
        nvcc_s = list(pool.map(lambda k: k.build(), kernels))
        count_lib = counting.result()
        oracle_host_fn = oracle_host.result()
    for k, s in zip(kernels, nvcc_s):
        k.function()
        print(f"phase 2: built {k.library_path().name} (nvcc {s:.2f} s)")
        for line in k.build_log.splitlines():
            if ("Compiling entry" in line or "registers" in line or "spill" in line
                    or "stack frame" in line):
                print(f"  ptxas: {line.strip()}")
        if k.name in BRUTE_FORCE_PTXAS:
            kernel, want = BRUTE_FORCE_PTXAS[k.name]
            got = [v for name, v in ptxas_by_entry(k.build_log).items()
                   if kernel in name]
            check(len(got) == 1 and sorted(got[0]) == sorted(want),
                  f"{k.name}: {kernel}'s ptxas resources changed: {got}")
            print(f"phase 2: {k.name}: {kernel}'s ptxas resources are unchanged")
    oracle_stack_check(ORACLE)
    print(f"phase 2: all {len(kernels)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s; the counting host build of "
          f"wf_level.cu and the host build of oracle.cu with g++")

    # Phases 3 and 4: each kernel against its plain version on the card.
    ds = default_scene(device=dev)
    d0 = RenderConfig(width=64, height=32, max_depth=0, alias_factor=1)
    cases = [
        ("default 64x32 a1 d0", ds, d0, {}, 0.01, 1e-3),
        ("default 64x32 a1 d1", ds, RenderConfig(width=64, height=32, max_depth=1, alias_factor=1), {}, 0.01, 1e-3),
        ("default 64x32 a1 d3", ds, RenderConfig(width=64, height=32, max_depth=3, alias_factor=1), {}, 0.01, 1e-3),
        ("default 64x32 a3 d2", ds, RenderConfig(width=64, height=32, max_depth=2, alias_factor=3), {}, 0.01, 1e-3),
        ("default 50x17 a1 d1", ds, RenderConfig(width=50, height=17, max_depth=1, alias_factor=1), {}, 0.01, 1e-3),
        ("random32 64x16 a1 d1", random_scene(32, seed=3, device=dev),
         RenderConfig(width=64, height=16, max_depth=1, alias_factor=1), {}, 0.01, 1e-3),
        # test_pallas.py:75-76's looser bounds for a frame of silhouettes.
        ("random256 64x8 a1 d1", random_scene(256, seed=3, device=dev),
         RenderConfig(width=64, height=8, max_depth=1, alias_factor=1), {}, 0.05, 3e-3),
        ("single 64x32 a1 d0", single_sphere_scene(device=dev), d0, {}, 0.0, 1e-3),
        ("default 64x32 a1 d2 offset=5 stride=3", ds,
         RenderConfig(width=64, height=32, max_depth=2, alias_factor=1),
         dict(offset=5, stride=3, count=600), 0.01, 1e-3),
    ]
    def same_as_ref(scene, cfg, label, **kw):
        """K1 against its reference instance (the previous design), bit for
        bit; returns K1's frame."""
        k = render_pixels_cuda(scene, cfg, **kw)
        ref = render_pixels_reference(scene, cfg, **kw)
        torch.cuda.synchronize()
        check(same_bits(k.contiguous(), ref.contiguous()),
              f"K1 on {label}: differs from its reference instance")
        return k

    rng = np.random.default_rng(0)
    for label, scene, cfg, kw, frac, mean in cases:
        k = same_as_ref(scene, cfg, label, **kw)
        p = render_pixels_torch(scene, cfg, **kw)
        s = contract(k.cpu(), p.cpu(), frac, mean)
        print(f"phase 3: {label}: outliers {s['outliers']:.5f} (<= {frac}) "
              f"mean/scale {s['mean_over_scale']:.3e} (< {mean}) "
              f"max_abs_err {s['max_abs_err']:.3e}; bit-identical to K1's "
              f"reference instance")
        if label.startswith("single"):
            continue  # the K2 cases are the issue's list
        g = torch.tensor(rng.uniform(0.5, 1.5, tuple(p.shape)).astype(np.float32),
                         device=dev)
        g, zeroed = masked_cotangent(k, p, g)
        gk = grad_pixels_cuda(scene, cfg, g, **kw)
        torch.cuda.synchronize()
        worst, max_abs = grad_contract(gk, grad_pixels_torch(scene, cfg, g, **kw))
        ref_err = ref_table_err(gk, grad_pixels_reference(scene, cfg, g, **kw))
        print(f"phase 4: {label}: cotangent zeroed on {zeroed} pixels; worst "
              f"relative gradient error {worst:.3e} (<= 5e-2), max abs "
              f"{max_abs:.3e}; against K2's reference instance "
              f"{ref_err:.3e} x scale (<= 1e-5)")

    # K1 against its reference instance beyond the cases above: alias 1-4,
    # alias 12 (a pixel's 144 samples in two rounds of a block's 128 slots),
    # a strided set with a clamped tail, and the largest tables K1 takes.
    extra = [
        ("default 64x32 a2 d3", ds, RenderConfig(width=64, height=32, max_depth=3, alias_factor=2), {}),
        ("default 50x17 a4 d4", ds, RenderConfig(width=50, height=17, max_depth=4, alias_factor=4), {}),
        ("random32 64x16 a3 d2", random_scene(32, seed=3, device=dev),
         RenderConfig(width=64, height=16, max_depth=2, alias_factor=3), {}),
        ("default 64x32 a3 d3 offset=5 stride=3 count=701", ds,
         RenderConfig(width=64, height=32, max_depth=3, alias_factor=3),
         dict(offset=5, stride=3, count=701)),
        ("default 16x8 a12 d2 offset=3 stride=5 count=29", ds,
         RenderConfig(width=16, height=8, max_depth=2, alias_factor=12),
         dict(offset=3, stride=5, count=29)),
        ("random(4096, 1024 lights) 8x4 a2 d1",
         random_scene(4096, num_lights=1024, seed=4, device=dev),
         RenderConfig(width=8, height=4, max_depth=1, alias_factor=2), {}),
    ]
    for label, scene, cfg, kw in extra:
        k = same_as_ref(scene, cfg, label, **kw)
        check(bool(torch.isfinite(k).all()), f"K1 on {label}: not finite")
    print(f"phase 3: K1 bit-identical to its reference instance on "
          f"{len(extra)} more cases: " + "; ".join(c[0] for c in extra))

    # Phase 5: anchor to the JAX reference's golden, written by raytpu.trace.
    cfg = RenderConfig(width=160, height=120, max_depth=4, alias_factor=3)
    img = same_as_ref(ds, cfg, "the 160x120 golden").reshape(120, 160, 3).cpu().numpy()
    ref = np.load(os.path.join(GOLDENS, "default_160x120_d4_linear.npy"))
    s = contract(img, ref)
    exact = float((tone_map(img) == read_ppm(
        os.path.join(GOLDENS, "default_160x120_d4.ppm"))).mean())
    print(f"phase 5: golden 160x120 d4 a3: outliers {s['outliers']:.5f} "
          f"mean/scale {s['mean_over_scale']:.3e} max_abs_err "
          f"{s['max_abs_err']:.3e}; PPM byte-exact fraction {exact:.6f}")

    # Phase 6: the render path through the CLI, as a user runs it.
    captured = []
    render_single = render.render_single

    def spy(*args, **kwargs):
        out = render_single(*args, **kwargs)
        captured.append(out)
        return out

    golden = BENCH_CONFIGS["golden"]
    with tempfile.TemporaryDirectory() as tmp:
        ppm = os.path.join(tmp, "golden.ppm")
        render.render_single = spy
        try:
            TRACE_FWD.launches = 0
            rc = cli.main(["-o", ppm])
            torch.cuda.synchronize()
            launches = TRACE_FWD.launches
        finally:
            render.render_single = render_single
        check(rc == 0, f"cli.main returned {rc}")
        check(launches >= 1, "the render path did not launch trace_fwd")
        check(len(captured) == 1, f"the CLI rendered {len(captured)} frames")
        img = captured[0]
        check(img.device.type == "cuda", f"the CLI rendered on {img.device}")
        check(tuple(img.shape) == (600, 800, 3), f"image shape {tuple(img.shape)}")
        img = img.cpu().numpy()
        check(np.isfinite(img).all(), "the CLI's image is not finite")
        check((read_ppm(ppm) == tone_map(img)).all(),
              "the PPM on disk is not the rendered frame")
        with open(ppm, "rb") as f:
            golden_ppm = f.read()
    plain = render.render_single(default_scene(device=dev), golden, backend="torch")
    s_main = contract(img, plain.cpu().numpy())
    ref = render_pixels_reference(default_scene(device=dev), golden)
    check(same_bits(torch.from_numpy(img).reshape(-1, 3), ref.cpu().contiguous()),
          "the CLI's golden frame differs from K1's reference instance")
    print(f"phase 6: cli golden 800x600 d5 a3: bit-identical to K1's reference "
          f"instance; trace_fwd launches {launches}; "
          f"vs plain outliers {s_main['outliers']:.5f} mean/scale "
          f"{s_main['mean_over_scale']:.3e} max_abs_err {s_main['max_abs_err']:.3e}")

    # Phase 7: the training path, config 3, through the fit example.
    c3 = BENCH_CONFIGS["config3"]
    first = []
    loss_and_grad_sharded = grad.loss_and_grad_sharded

    def spy_grad(scene, *args, **kwargs):  # fit_scene's every step
        out = loss_and_grad_sharded(scene, *args, **kwargs)
        if not first:  # the optimizer then updates its leaves in place
            first.append((scene_from_leaves([t.clone() for t in scene_leaves(scene)]),
                          out[:2]))
        return out

    grad.loss_and_grad_sharded = spy_grad
    try:
        TRACE_FWD.launches = TRACE_BWD.launches = 0
        fit = fit_example.main([
            "--width", str(c3.width), "--height", str(c3.height),
            "--depth", str(c3.max_depth), "--alias-factor", str(c3.alias_factor),
            "--mode", "geometry", "--steps", "3", "--backend", "cuda"])
        torch.cuda.synchronize()
        fwd_launches, bwd_launches = TRACE_FWD.launches, TRACE_BWD.launches
    finally:
        grad.loss_and_grad_sharded = loss_and_grad_sharded
    check(fwd_launches >= 1, "the training path did not launch trace_fwd")
    check(bwd_launches >= 1, "the training path did not launch trace_bwd")
    losses = fit["losses"]
    check(len(losses) == 3 and all(np.isfinite(losses)), f"losses {losses}")
    check(fit["fitted"].device.type == "cuda", "the fit ran off the card")
    print(f"phase 7: fit config 3 (640x480 d4 a3, geometry, 3 steps): "
          f"trace_fwd launches {fwd_launches}, trace_bwd launches "
          f"{bwd_launches}; loss {fit['start_loss']:.6e} -> "
          + " -> ".join(f"{v:.6e}" for v in losses))

    scene0, (_, grads0) = first[0]
    target = fit["target"]
    k_fwd = render_pixels_cuda(scene0, c3)
    g = 2.0 * (k_fwd - target) / k_fwd.numel()  # d mean((pred - target)^2)
    worst, _ = grad_contract(grads0, grad_pixels_cuda(scene0, c3, g))
    print(f"phase 7: first step's gradient vs trace_bwd on its own cotangent: "
          f"worst relative error {worst:.3e} (<= 5e-2; atomics' order)")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_fwd = render_pixels_torch(scene0, c3)
    torch.cuda.synchronize()
    plain_fwd_s = time.perf_counter() - t0
    s_fwd = contract(k_fwd.cpu(), p_fwd.cpu())
    g_m, zeroed = masked_cotangent(k_fwd, p_fwd, g)
    gk = grad_pixels_cuda(scene0, c3, g_m)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gp = grad_pixels_torch(scene0, c3, g_m)
    torch.cuda.synchronize()
    plain_bwd_s = time.perf_counter() - t0
    bwd_err, bwd_abs = grad_contract(gk, gp)
    k2_ref_err = ref_table_err(gk, grad_pixels_reference(scene0, c3, g_m))
    print(f"phase 7: trace_bwd vs its reference instance at config 3: every "
          f"table within {k2_ref_err:.3e} x scale (<= 1e-5)")
    print(f"phase 7: trace_fwd vs plain at config 3: outliers "
          f"{s_fwd['outliers']:.5f} max_abs_err {s_fwd['max_abs_err']:.3e} "
          f"(plain forward {plain_fwd_s * 1e3:.1f} ms)")
    print(f"phase 7: trace_bwd vs plain at config 3: cotangent zeroed on "
          f"{zeroed} of {c3.num_pixels} pixels; worst relative gradient error "
          f"{bwd_err:.3e} (<= 5e-2), max abs {bwd_abs:.3e}; plain gradient "
          f"{plain_bwd_s * 1e3:.1f} ms (one run)")

    # Phase 8: times, kernel and plain version in turns on one card.
    timer = Timer(dev)
    step = lambda: grad.loss_and_grad(scene0, c3, target, backend="cuda")  # noqa: E731
    bwd = lambda: grad_pixels_cuda(scene0, c3, g)  # noqa: E731
    step(), bwd()  # warm-up
    for _ in range(5):
        with timer.section("step"):
            step()
        with timer.section("bwd"):
            bwd()
    step_ms, bwd_ms = median_ms(timer, "step"), median_ms(timer, "bwd")
    print(f"phase 8: config3 training step (loss_and_grad, kernel pair): "
          f"{step_ms:.3f} ms")
    print(f"phase 8: config3 training step: "
          f"{c3.rays_per_frame / step_ms / 1e3:.2f} camera Mrays/s fwd+bwd")
    print(f"phase 8: config3 trace_bwd alone: {bwd_ms:.3f} ms")
    # K2 against its reference instance (the previous design), in turns.
    k2_ref_ms, k2_turn_ms, _, _ = turns(
        lambda: grad_pixels_reference(scene0, c3, g),
        lambda: grad_pixels_cuda(scene0, c3, g), rounds=3)
    print(f"phase 8: config3 trace_bwd {k2_turn_ms:.3f} ms against its reference "
          f"instance {k2_ref_ms:.3f} ms in turns ({k2_ref_ms / k2_turn_ms:.2f}x)")
    # K1 against its reference instance at config 3: bit for bit at alias
    # 1-4; at alias 3 in turns (one call between two events, host work
    # included), its device time back to back (the profiler's kernel time
    # over 20 calls, and CUDA events around 30 calls in a row), and the
    # wrapper's host work split by a host clock.
    for alias in (1, 2, 3, 4):
        same_as_ref(ds, RenderConfig(width=c3.width, height=c3.height,
                                     max_depth=c3.max_depth, alias_factor=alias),
                    f"config 3 at alias {alias}")
    k1_ref_ms, k1_turn_ms, _, _ = turns(
        lambda: render_pixels_reference(ds, c3),
        lambda: render_pixels_cuda(ds, c3), rounds=3)
    k1 = dict(turn_ms=k1_turn_ms, ref_ms=k1_ref_ms)
    for key, fn, kernel in (
            ("", lambda: render_pixels_cuda(ds, c3), "trace_fwd_kernel"),
            ("ref_", lambda: render_pixels_reference(ds, c3), "trace_fwd_ref_kernel")):
        k1[key + "device_ms"] = kernel_device_ms(fn, kernel)
        k1[key + "back_to_back_ms"] = back_to_back_ms(fn)
    import raytpu_torch.kernels.trace_cuda as trace_cuda
    from raytpu_torch.trace import camera_constants

    tables = scene_tables(ds)
    out3 = torch.empty((3, c3.num_pixels), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (tables[0].data_ptr(), ds.spheres.count, tables[1].data_ptr(), ds.lights.count,
            tables[2].data_ptr(), out3.data_ptr(), 0, c3.num_pixels, 1,
            c3.num_pixels, c3.width, c3.alias_factor, c3.max_depth,
            *camera_constants(c3), 0, stream)
    entry = TRACE_FWD.function()
    k1["host_us"] = host_us({
        "_check_scene": lambda: trace_cuda._check_scene(ds, dev),
        "scene_tables": lambda: scene_tables(ds),
        "camera_constants": lambda: camera_constants(c3),
        "torch.empty": lambda: torch.empty((3, c3.num_pixels), device=dev),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "C entry (launch)": lambda: entry(*args),
        "render_pixels_cuda": lambda: render_pixels_cuda(ds, c3),
        "render_single": lambda: render.render_single(ds, c3, "cuda"),
    })
    fmt = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    print(f"phase 8: config3 K1 bit-identical to its reference instance at "
          f"alias 1-4; at alias 3 in turns {k1_turn_ms:.3f} ms against the "
          f"reference's {k1_ref_ms:.3f} ms ({k1_ref_ms / k1_turn_ms:.2f}x); "
          f"device time a launch (profiler) K1 {fmt(k1['device_ms'])}, reference "
          f"{fmt(k1['ref_device_ms'])}; back to back (30 calls) K1 "
          f"{k1['back_to_back_ms']:.4f} ms, reference {k1['ref_back_to_back_ms']:.4f} ms")
    print("phase 8: config3 K1 wrapper host work, us a call: " + ", ".join(
        f"{k} {v:.1f}" for k, v in k1["host_us"].items()))
    times = {}
    for key in ("config3", "golden"):
        cfg = BENCH_CONFIGS[key]
        timer = Timer(dev)
        for backend in ("cuda", "torch"):
            render.render_single(ds, cfg, backend)  # warm-up
        for _ in range(5):
            for backend in ("cuda", "torch"):
                with timer.section(backend):
                    render.render_single(ds, cfg, backend)
        kms, pms = median_ms(timer, "cuda"), median_ms(timer, "torch")
        times[key] = (kms, pms)
        for label, ms in (("kernel", kms), ("plain", pms)):
            print(f"phase 8: {key} {cfg.width}x{cfg.height} d{cfg.max_depth} "
                  f"a{cfg.alias_factor} {label}: {ms:.3f} ms "
                  f"{cfg.rays_per_frame / ms / 1e3:.2f} camera Mrays/s")

    # Phase 9: each kernel's bound at config 3, default scene.
    work = tree_work(scene0, c3)
    n_tbl = 12 * scene0.spheres.count + 6 * scene0.lights.count + 5
    fwd_bound = bound_ms(work, n_tbl, c3.num_pixels, backward=False)
    bwd_bound = bound_ms(work, n_tbl, c3.num_pixels, backward=True)
    print("phase 9: config3 work " + json.dumps(work))
    for label, (ms, by, ops, nbytes) in (("trace_fwd", fwd_bound),
                                         ("trace_bwd", bwd_bound)):
        print(f"phase 9: {label} bound {ms:.4f} ms by {by} ({ops / 1e9:.3f} "
              f"GFLOP at 67 TFLOP/s, {nbytes / 1e6:.3f} MB at 3.35 TB/s)")
    k3, k5, frame11 = wavefront_phases(dev, count_lib)
    k4, k6 = training_phases(dev)
    fault_phase(dev)
    sharded = sharded_phase(dev, frame11, golden_ppm)
    oracle_launches, oracle_times = oracle_phase(dev, oracle_host_fn)
    (packed_fwd, packed_bwd), packed = packed_phase(dev, smi)
    bench_line = bench_phase(dev)
    chunks = chunks_phase(dev, smi)
    tools = tools_phase()
    # The wavefront kernels' launches: their main path's (the CLI's frame,
    # phase 11, for K3 and K5; the config-5 fit, phase 14, for K4 and K6),
    # phase 21's chunk loop and phase 22's tools.
    for entry, kname, path in ((k3, "wf_level", "cli"), (k5, "wf_compact", "cli"),
                               (k4, "wf_level_bwd", "fit"),
                               (k6, "wf_uncompact", "fit")):
        entry["launches_by_path"] = {path: entry["launches"],
                                     "chunks": chunks["launches"][kname],
                                     "tools": tools["launches"][kname]}
        entry["launches"] += chunks["launches"][kname] + tools["launches"][kname]
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    print(smi)
    entries = [
        {"name": "trace_fwd", "route": "cuda",
         "source": os.path.relpath(str(TRACE_FWD.source), ROOT),
         "replaces": "raytpu/kernels/trace_pallas.py:798",
         "launches": fwd_launches + packed_fwd + tools["launches"]["trace_fwd"],
         "launches_by_path": {"fit": fwd_launches, "packed": packed_fwd,
                              "tools": tools["launches"]["trace_fwd"]},
         "max_abs_err": s_fwd["max_abs_err"],
         "ms": times["config3"][0], "plain_ms": times["config3"][1],
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
         **k1, "library_ms": None},
        {"name": "trace_bwd", "route": "cuda",
         "source": os.path.relpath(str(TRACE_BWD.source), ROOT),
         "replaces": "raytpu/kernels/trace_pallas.py:1248",
         "launches": bwd_launches + packed_bwd + tools["launches"]["trace_bwd"],
         "launches_by_path": {"fit": bwd_launches, "packed": packed_bwd,
                              "tools": tools["launches"]["trace_bwd"]},
         "max_abs_err": bwd_abs,
         "max_rel_err": bwd_err, "ms": bwd_ms, "plain_ms": plain_bwd_s * 1e3,
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
         "ref_ms": k2_ref_ms, "ref_turn_ms": k2_turn_ms,
         "ref_table_err": k2_ref_err, "library_ms": None},
        {"name": "wf_level", "route": "cuda",
         "source": os.path.relpath(str(WF_LEVEL.source), ROOT),
         "replaces": "raytpu/kernels/wavefront.py:153", **k3,
         "library_ms": None},
        {"name": "wf_compact", "route": "cuda",
         "source": os.path.relpath(str(WF_COMPACT.source), ROOT),
         "replaces": "raytpu/kernels/wavefront.py:476", **k5,
         "library_ms": None},
        {"name": "wf_level_bwd", "route": "cuda",
         "source": os.path.relpath(str(WF_LEVEL_BWD.source), ROOT),
         "replaces": "raytpu/kernels/wavefront.py:265", **k4},
        {"name": "wf_uncompact", "route": "cuda",
         "source": os.path.relpath(str(WF_UNCOMPACT.source), ROOT),
         "replaces": "raytpu/kernels/wavefront.py:591", **k6}]
    print(f"phase 17: each kernel's launches on the sharded paths "
          f"{json.dumps(sharded)}")
    print("phase 18: oracle kernel vs plain version at 800x600 a3, ms "
          + json.dumps({"kernel_ms": {k: v[0] for k, v in oracle_times.items()},
                        "plain_ms": {k: v[1] for k, v in oracle_times.items()},
                        "launches": oracle_launches}))
    print("phase 19: packed-tile step and culling " + json.dumps(packed))
    print("phase 20: bench " + json.dumps(bench_line))
    print("phase 21: chunk loop " + json.dumps(chunks))
    print(f"phase 22: the tools in {tools['seconds']:.1f} s, launches "
          + json.dumps(tools["launches"]))
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
