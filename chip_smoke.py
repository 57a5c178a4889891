#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (raytpu_torch) once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
result lines):
  1. a CUDA device is present; print its nvidia-smi name and power limit;
  2. build every kernel (trace_fwd, trace_bwd, wf_level, wf_compact) from
     raytpu_torch/csrc, one nvcc each, all started together; print their
     ptxas resources;
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
     (640x480, depth 4, 3x3 AA), 3 geometry steps with --backend auto,
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
     plain versions, and their bounds for that work.
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


def wavefront_phases(dev):
    """Phases 10-12: the wavefront path (K3 and K5) at config 5.  Returns
    the two kernels' entries of the kernels JSON line."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import raytpu_torch.render as render
    from raytpu_torch import cli
    from raytpu_torch.config import BENCH_CONFIGS, RenderConfig
    from raytpu_torch.image import read_ppm, tone_map
    from raytpu_torch.kernels.trace_cuda import render_pixels_cuda, scene_tables
    from raytpu_torch.kernels.wavefront import (WF_COMPACT, WF_LEVEL,
                                                chunk_camera_state, compact,
                                                compact_torch,
                                                render_pixels_wavefront,
                                                wavefront_sizes, wf_level,
                                                wf_level_torch)
    from raytpu_torch.scene import default_scene, random_scene
    from raytpu_torch.utils.profiling import Timer

    c5 = BENCH_CONFIGS["config5"]
    s5 = random_scene(256, seed=3, device=dev)
    tables = scene_tables(s5)
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
        em, ch = wf_level(s5, state, True, tables)
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

    # K3 and K5 alone on chunk 0 of config 5, every level: kernel (median of
    # 3 after 1 warm-up) and plain version (one run) on the same inputs, and
    # the bounds of that work: K3's operations from the plain version's masks
    # (FWD_OPS without the camera's "sample"), its bytes as 10 fields in, 3
    # out and 20 child fields out per ray slot; K5's bytes as the 3
    # intensities of every child, the other 7 fields of the kept ones, the
    # parents' pids and 11 words per output slot.
    state, pid = chunk_camera_state(c5, chunk, n_chunks, 0, c5.num_pixels,
                                    device=dev)
    k3_ms = k3_plain = k3_live_ms = k5_ms = k5_plain = 0.0
    k3_ops = k3_bytes = k5_bytes = 0
    for level in range(c5.max_depth + 1):
        spawn = level < c5.max_depth
        rays = state.shape[1]
        ms, (em, ch) = events_ms(lambda: wf_level(s5, state, spawn, tables))
        # The same level launched over its live prefix only (the kept rays
        # lead the state): what the dead slots cost K3.
        live_state = state[:, :int((state[6:9] != 0).any(dim=0).sum())].contiguous()
        live_ms, _ = events_ms(lambda: wf_level(s5, live_state, spawn, tables))
        k3_live_ms += live_ms
        pms, _ = events_ms(lambda: wf_level_torch(s5, state, spawn), reps=1, warmup=0)
        work = wavefront_level_work(s5, state, spawn)
        ops = sum(FWD_OPS[k] * work[k] for k in FWD_OPS if k != "sample")
        k3_ms, k3_plain, k3_ops = k3_ms + ms, k3_plain + pms, k3_ops + ops
        k3_bytes += 4 * rays * (10 + 3 + (20 if spawn else 0))
        line = (f"phase 12: config5 chunk 0 level {level}: {rays} ray slots, "
                f"{work['node']} live; K3 {ms:.3f} ms ({live_ms:.3f} ms over "
                f"the live prefix only), plain {pms:.3f} ms, {ops / 1e9:.4f} GFLOP")
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

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / PEAK_FP32, nbytes / PEAK_BYTES
        return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"

    k3_bound, k5_bound = bound(k3_ops, k3_bytes), bound(0, k5_bytes)
    print(f"phase 12: config5 chunk 0, {c5.max_depth + 1} levels: K3 {k3_ms:.3f} ms "
          f"({k3_live_ms:.3f} ms over the live prefixes; plain {k3_plain:.3f} ms), bound {k3_bound[0]:.4f} ms by {k3_bound[1]} "
          f"({k3_ops / 1e9:.3f} GFLOP at 67 TFLOP/s, {k3_bytes / 1e6:.3f} MB at "
          f"3.35 TB/s); K5 {k5_ms:.3f} ms (plain {k5_plain:.3f} ms), bound "
          f"{k5_bound[0]:.4f} ms by bytes ({k5_bytes / 1e6:.3f} MB)")
    work_note = f"config5 chunk 0 ({chunk} camera rays), all {c5.max_depth + 1} levels"
    k3 = {"launches": l3, "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain,
          "bound_ms": k3_bound[0], "bound_by": k3_bound[1], "work": work_note,
          "frame_ms": wf_ms}
    k5 = {"launches": l5, "max_abs_err": 0.0, "ms": k5_ms, "plain_ms": k5_plain,
          "bound_ms": k5_bound[0], "bound_by": k5_bound[1], "work": work_note}
    return k3, k5


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
                                                chunk_camera_state, compact,
                                                compact_torch,
                                                render_pixels_wavefront,
                                                wavefront_sizes, wf_level,
                                                wf_level_torch)
    from raytpu_torch.scene import (default_scene, random_scene,
                                    scene_from_leaves, scene_leaves,
                                    single_sphere_scene)
    from raytpu_torch.utils.profiling import Timer

    dev = torch.device("cuda:0")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(dev)
    print(f"phase 1: device {name} | nvidia-smi: {smi}")

    # Phase 2: build, one nvcc per source, all at once.
    kernels = (TRACE_FWD, TRACE_BWD, WF_LEVEL, WF_COMPACT)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        nvcc_s = list(pool.map(lambda k: k.build(), kernels))
    for k, s in zip(kernels, nvcc_s):
        k.function()
        print(f"phase 2: built {k.library_path().name} (nvcc {s:.2f} s)")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"phase 2: all {len(kernels)} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")

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
            "--mode", "geometry", "--steps", "3", "--backend", "auto"])
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
    step = lambda: grad.loss_and_grad(scene0, c3, target)  # noqa: E731
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
    k3, k5 = wavefront_phases(dev)
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
         "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
