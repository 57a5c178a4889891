#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (raytpu_torch) once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
result lines):
  1. a CUDA device is present; print its nvidia-smi name and power limit;
  2. build every kernel (trace_fwd, trace_bwd, wf_level, wf_compact,
     wf_level_bwd, wf_uncompact) from raytpu_torch/csrc, one nvcc each, all
     started together, and wf_level.cu's counting host build (g++
     -DRT_BVH_COUNT); print every instance's ptxas resources and hold K1's
     and K2's to the lines they had before the sphere queries became a
     policy (the policies leave their code as it was);
  3. hold the forward kernel against its plain PyTorch version on the card,
     under the forward contract of tests/test_pallas.py (outlier fraction
     <= 1% at 1e-2*scale, mean abs diff < 1e-3*scale);
  4. hold the backward kernel against its plain version (autograd of the
     eager tracer) on the same cases, under the gradient contract of
     tests/test_pallas.py:304-314 (rtol 5e-2 where |plain| > 1e-3*scale),
     the cotangent zeroed on the pixels whose forwards differ by more than
     1e-5*scale;
  5. anchor to the JAX reference without JAX: the forward kernel against
     the linear golden written by raytpu.trace (tests/goldens);
  6. the render path: raytpu_torch.cli.main(["-o", <tmp>.ppm]), the golden
     800x600 depth-5 3x3 render with --backend auto, counting trace_fwd's
     launches and holding the image against the plain version;
  7. the training path: raytpu_torch.examples.fit_scene.main at config 3
     (640x480, depth 4, 3x3 AA), 3 geometry steps with --backend cuda (the
     kernel pair; "auto" trains a frame this size through the wavefront),
     counting both kernels' launches; the fit's first gradient against
     the kernel's and, on the masked cotangent, against the plain version;
  8. time the config-3 training step and the backward kernel alone, then
     config 3 and the golden frame's forward, kernel against plain version,
     with CUDA events (median of 5 after 1 warm-up);
  9. each kernel's bound at config 3: operations counted from the sources
     over the work the plain version's masks show, against 67 TFLOP/s, and
     bytes against 3.35 TB/s;
 10. the wavefront's kernels against their plain versions at config 5's
     widths (random_scene(256, seed=3), chunk 0 at the auto ladder's first
     rung): the level kernel (K3) under the forward contract at level 0 and
     the first two compacted levels, the compaction (K5) bit for bit, also
     at a capacity below the live count so that its drop path runs;
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
     dead rays; the compaction's transpose (K6) bit for bit, also at a
     capacity below the live count;
 14. the wavefront training path: raytpu_torch.grad.fit_scene at config 5
     with backend="wavefront", 3 steps of matte and light colours from the
     fit example's perturbation, counting K3, K4, K5 and K6 launches (chunks
     x 7, chunks x 7, chunks x 6 x 2, chunks x 6 per step tried), no dropped
     ray, the loss falling or holding, and the first step's loss and
     gradient against the kernel pair's (tests/test_wavefront.py:196-219's
     contract); then the fit example with --backend wavefront at config 3;
 15. times: the config-5 training step, wavefront against the kernel pair
     (in turns, median of 3 after 1 warm-up) with its peak memory; a
     torch.profiler breakdown of one wavefront step; a chunk sweep of the
     step; the training crossover at the ten 640x480 cells of phase 12; K4
     and K6 alone on config 5's chunk 0 at every level against their plain
     versions (and K6 against torch.zeros + index_copy_); K4 (from K3's
     sel) against its reference instance (re-running the brute-force
     queries), d_state bit for bit and the tables within 1e-5 x scale, in
     turns; their bounds, K4's beside the reference algorithm's.
The last three lines are nvidia-smi's, the kernels JSON and
{"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import os
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


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


# K1's and K2's ptxas resource lines (sm_90a) from before the sphere
# queries became a policy of trace_common.cuh: the brute-force policy they
# use must leave their code unchanged.
BRUTE_FORCE_PTXAS = {
    "trace_fwd": ("496 bytes stack frame, 20 bytes spill stores, 12 bytes spill loads",
                  "Used 64 registers, used 1 barriers, 496 bytes cumulative stack size"),
    "trace_bwd": ("2176 bytes stack frame, 24 bytes spill stores, 16 bytes spill loads",
                  "Used 128 registers, used 1 barriers, 2176 bytes cumulative stack size"),
}


def ptxas_resources(log):
    """The resource lines of an nvcc -Xptxas -v log, without their prefix."""
    out = []
    for line in log.splitlines():
        if "registers" in line or "stack frame" in line:
            out.append(line.split("ptxas info    : ")[-1].strip())
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
    return float(np.median(timer.summary()[name])) * 1e3


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


def same_bits(a, b):
    """Tensors equal bit for bit (floats compared as their int32 words)."""
    import torch

    if a is None or b is None:
        return a is None and b is None
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


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
                 else "wf_compact" if "wf_count_kernel" in name or "wf_scatter_kernel" in name
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
        k, w = (float(np.median(timer.summary()[n][1:])) * 1e3 for n in ("k1", "wf"))
        auto = render.resolve_backend("auto", dev, sc, cfg)
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
    st_ms, sy_ms = (float(np.median(timer.summary()[m][1:])) * 1e3
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
    return k3, k5


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
            out = compact(kids, pid, keep_n, ws, return_src=True)
            check(same(out, compact_torch(kids, pid, keep_n, ws, return_src=True)),
                  f"K5 with its source index, level {level}: differs from plain")
            gen = torch.Generator(device=dev).manual_seed(100 + level)
            d = torch.randn((10, keep_n), generator=gen, device=dev)
            back = uncompact(d, out[4], kids.shape[1])
            torch.cuda.synchronize()
            check(torch.equal(back, uncompact_torch(d, out[4], kids.shape[1])),
                  f"K6 level {level} cap {keep_n}: differs from uncompact_torch")
            line += (f"; K6 bit-identical at cap {keep_n} ({int(out[2])} "
                     f"dropped)")
        print(line)
        state, pid = compact(kids, pid, min(2 * state.shape[1], cap), ws)[:2]

    # Phase 14: the slice's path, fit_scene(backend="wavefront") at config 5.
    truth = random_scene(256, seed=3, device=dev)
    start = fit_example.perturb(truth, geometry=False)
    with torch.no_grad():
        target = render.render_single(truth, c5, "wavefront").reshape(-1, 3)
    trainable = scene_from_leaves([n in ("spheres.matte", "lights.col")
                                   for n in LEAF_NAMES])
    calls = []
    real = grad.loss_and_grad_wavefront

    def spy(scene, cfg, target_flat, **kw):
        out = real(scene, cfg, target_flat, **kw)
        calls.append((scene, out, kw))
        return out

    grad.loss_and_grad_wavefront = spy
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
        grad.loss_and_grad_wavefront = real
    chunks = [wavefront_sizes(c5, kw["chunk_rays"], kw["capacity_factor"])[3]
              for _, _, kw in calls]
    levels = c5.max_depth + 1
    check((l3, l4, l5, l6) == (sum(chunks) * levels, sum(chunks) * levels,
                               sum(chunks) * (levels - 1) * 2,
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
                 else "K5 wf_compact" if "wf_count_kernel" in name or "wf_scatter_kernel" in name
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
    # way, in turns (median of the last 3 of 4).
    cells = [(3, 4), (16, 4), (64, 2), (32, 4), (128, 2), (16, 6), (64, 4),
             (256, 2), (64, 6), (256, 4)]
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
        k, w = (float(np.median(timer.summary()[n][1:])) * 1e3 for n in ("k2", "wf"))
        auto = grad.resolve_train_backend("auto", sc, cfg)
        print(f"phase 15: training crossover N={sc.spheres.count} 640x480 d{depth}: "
              f"N*d {sc.spheres.count * depth}; K1 + K2 {k:.3f} ms, wavefront "
              f"{w:.3f} ms ({w / k:.3f}x; dropped {infos[-1]['dropped']}); "
              f"training auto picks {auto}")

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
    # state takes none).  K6: 10 floats read per kept slot and 9 written
    # per child slot.
    state, pid = chunk_camera_state(c5, chunk, n_chunks, 0, c5.num_pixels,
                                    device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    k4_ms = k4_ref_ms = k4_plain = k6_ms = k6_plain = k6_lib = 0.0
    k4_ops = k4_ref_ops = k4_bytes = k6_bytes = 0
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
            out = compact(kids, pid, keep_n, ws, return_src=True)
            kept = int(out[3])
            d = torch.randn((10, keep_n), generator=gen, device=dev)
            src = out[4]
            cms, _ = events_ms(lambda: uncompact(d, src, kids.shape[1]))
            cpms, _ = events_ms(lambda: uncompact_torch(d, src, kids.shape[1]),
                                reps=1, warmup=0)
            cols = src[:kept].long()

            def library():
                o = torch.zeros((10, kids.shape[1]), device=dev)
                return o.index_copy_(1, cols, d[:, :kept])

            lms, lib_out = events_ms(library)
            check(torch.equal(lib_out[:9], uncompact(d, src, kids.shape[1])[:9]),
                  f"level {level}: the library yardstick computes another function")
            k6_ms, k6_plain, k6_lib = k6_ms + cms, k6_plain + cpms, k6_lib + lms
            k6_bytes += 4 * (10 * kept + 9 * kids.shape[1])
            line += (f"; K6 {cms:.3f} ms, plain {cpms:.3f} ms, zeros + index_copy_ "
                     f"{lms:.3f} ms, {kept} kept of {kids.shape[1]}")
            state, pid = out[0], out[1]
        print(line)

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"

    k4_bound, k6_bound = bound(k4_ops, k4_bytes), bound(0, k6_bytes)
    k4_ref_bound = bound(k4_ref_ops, k4_bytes)
    print(f"phase 15: config5 chunk 0, {levels} levels: K4 {k4_ms:.3f} ms against "
          f"its reference {k4_ref_ms:.3f} ms ({k4_ref_ms / k4_ms:.2f}x; plain "
          f"{k4_plain:.3f} ms), bound {k4_bound[0]:.4f} ms by {k4_bound[1]} "
          f"({k4_ops / 1e9:.3f} GFLOP at 67 TFLOP/s, {k4_bytes / 1e6:.3f} MB at "
          f"3.35 TB/s), the reference algorithm's bound {k4_ref_bound[0]:.4f} ms "
          f"({k4_ref_ops / 1e9:.3f} GFLOP); K6 {k6_ms:.3f} ms (plain {k6_plain:.3f} ms, zeros + "
          f"index_copy_ {k6_lib:.3f} ms), bound {k6_bound[0]:.4f} ms by bytes "
          f"({k6_bytes / 1e6:.3f} MB)")
    work_note = f"config5 chunk 0 ({chunk} camera rays), all {levels} levels"
    k4 = {"launches": l4, "max_abs_err": k4_err, "max_rel_err": k4_rel,
          "ms": k4_ms, "plain_ms": k4_plain,
          "bound_ms": k4_bound[0], "bound_by": k4_bound[1], "ref_ms": k4_ref_ms,
          "ref_bound_ms": k4_ref_bound[0], "ref_bound_by": k4_ref_bound[1],
          "ref_table_err": k4_tbl_err, "work": work_note,
          "step_ms": wf_ms, "library_ms": None}
    k6 = {"launches": l6, "max_abs_err": 0.0, "ms": k6_ms, "plain_ms": k6_plain,
          "bound_ms": k6_bound[0], "bound_by": k6_bound[1], "work": work_note,
          "library_ms": k6_lib}
    return k4, k6


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
    from raytpu_torch.examples import fit_scene as fit_example
    from raytpu_torch.image import read_ppm, tone_map
    from raytpu_torch.kernels.trace_cuda import (TRACE_BWD, TRACE_FWD,
                                                 grad_pixels_cuda,
                                                 grad_pixels_torch,
                                                 render_pixels_cuda,
                                                 render_pixels_torch,
                                                 scene_tables)
    from raytpu_torch.kernels.wavefront import (WF_COMPACT, WF_LEVEL,
                                                WF_LEVEL_BWD, WF_UNCOMPACT)
    from raytpu_torch.scene import (default_scene, random_scene,
                                    scene_from_leaves, scene_leaves,
                                    single_sphere_scene)
    from raytpu_torch.utils.profiling import Timer

    dev = torch.device("cuda:0")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(dev)
    print(f"phase 1: device {name} | nvidia-smi: {smi}")

    # Phase 2: build, one nvcc per source, all at once (and the counting
    # host build of the level kernel for phase 12's bound).
    kernels = (TRACE_FWD, TRACE_BWD, WF_LEVEL, WF_COMPACT, WF_LEVEL_BWD,
               WF_UNCOMPACT)
    for k in kernels:  # a cached library has no ptxas lines to hold
        if k.library_path().exists():
            k.library_path().unlink()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels) + 1) as pool:
        counting = pool.submit(build_counting_host)
        nvcc_s = list(pool.map(lambda k: k.build(), kernels))
        count_lib = counting.result()
    for k, s in zip(kernels, nvcc_s):
        k.function()
        print(f"phase 2: built {k.library_path().name} (nvcc {s:.2f} s)")
        for line in k.build_log.splitlines():
            if ("Compiling entry" in line or "registers" in line or "spill" in line
                    or "stack frame" in line):
                print(f"  ptxas: {line.strip()}")
        if k.name in BRUTE_FORCE_PTXAS:
            got = sorted(ptxas_resources(k.build_log))
            check(got == sorted(BRUTE_FORCE_PTXAS[k.name]),
                  f"{k.name}'s ptxas resources changed: {got}")
            print(f"phase 2: {k.name}'s ptxas resources are unchanged")
    print(f"phase 2: all {len(kernels)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s; the counting host build of "
          f"wf_level.cu with g++")

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
    rng = np.random.default_rng(0)
    for label, scene, cfg, kw, frac, mean in cases:
        k = render_pixels_cuda(scene, cfg, **kw)
        torch.cuda.synchronize()
        p = render_pixels_torch(scene, cfg, **kw)
        s = contract(k.cpu(), p.cpu(), frac, mean)
        print(f"phase 3: {label}: outliers {s['outliers']:.5f} (<= {frac}) "
              f"mean/scale {s['mean_over_scale']:.3e} (< {mean}) "
              f"max_abs_err {s['max_abs_err']:.3e}")
        if label.startswith("single"):
            continue  # the K2 cases are the issue's list
        g = torch.tensor(rng.uniform(0.5, 1.5, tuple(p.shape)).astype(np.float32),
                         device=dev)
        g, zeroed = masked_cotangent(k, p, g)
        gk = grad_pixels_cuda(scene, cfg, g, **kw)
        torch.cuda.synchronize()
        worst, max_abs = grad_contract(gk, grad_pixels_torch(scene, cfg, g, **kw))
        print(f"phase 4: {label}: cotangent zeroed on {zeroed} pixels; worst "
              f"relative gradient error {worst:.3e} (<= 5e-2), max abs "
              f"{max_abs:.3e}")

    # Phase 5: anchor to the JAX reference's golden, written by raytpu.trace.
    cfg = RenderConfig(width=160, height=120, max_depth=4, alias_factor=3)
    img = render_pixels_cuda(ds, cfg).reshape(120, 160, 3).cpu().numpy()
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
    plain = render.render_single(default_scene(device=dev), golden, backend="torch")
    s_main = contract(img, plain.cpu().numpy())
    print(f"phase 6: cli golden 800x600 d5 a3: trace_fwd launches {launches}; "
          f"vs plain outliers {s_main['outliers']:.5f} mean/scale "
          f"{s_main['mean_over_scale']:.3e} max_abs_err {s_main['max_abs_err']:.3e}")

    # Phase 7: the training path, config 3, through the fit example.
    c3 = BENCH_CONFIGS["config3"]
    first = []
    loss_and_grad = grad.loss_and_grad

    def spy_grad(scene, *args, **kwargs):
        out = loss_and_grad(scene, *args, **kwargs)
        if not first:  # the optimizer then updates its leaves in place
            first.append((scene_from_leaves([t.clone() for t in scene_leaves(scene)]),
                          out))
        return out

    grad.loss_and_grad = spy_grad
    try:
        TRACE_FWD.launches = TRACE_BWD.launches = 0
        fit = fit_example.main([
            "--width", str(c3.width), "--height", str(c3.height),
            "--depth", str(c3.max_depth), "--alias-factor", str(c3.alias_factor),
            "--mode", "geometry", "--steps", "3", "--backend", "cuda"])
        torch.cuda.synchronize()
        fwd_launches, bwd_launches = TRACE_FWD.launches, TRACE_BWD.launches
    finally:
        grad.loss_and_grad = loss_and_grad
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
    k3, k5 = wavefront_phases(dev, count_lib)
    k4, k6 = training_phases(dev)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")

    print(smi)
    print(json.dumps({"kernels": [
        {"name": "trace_fwd", "route": "cuda",
         "source": os.path.relpath(str(TRACE_FWD.source), ROOT),
         "replaces": "raytpu/kernels/trace_pallas.py:798",
         "launches": fwd_launches, "max_abs_err": s_fwd["max_abs_err"],
         "ms": times["config3"][0], "plain_ms": times["config3"][1],
         "bound_ms": fwd_bound[0], "bound_by": fwd_bound[1],
         "library_ms": None},
        {"name": "trace_bwd", "route": "cuda",
         "source": os.path.relpath(str(TRACE_BWD.source), ROOT),
         "replaces": "raytpu/kernels/trace_pallas.py:1248",
         "launches": bwd_launches, "max_abs_err": bwd_abs,
         "max_rel_err": bwd_err, "ms": bwd_ms, "plain_ms": plain_bwd_s * 1e3,
         "bound_ms": bwd_bound[0], "bound_by": bwd_bound[1],
         "library_ms": None},
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
         "replaces": "raytpu/kernels/wavefront.py:591", **k6}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
