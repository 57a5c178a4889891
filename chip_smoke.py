#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (raytpu_torch) once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
result lines):
  1. a CUDA device is present; print its nvidia-smi name and power limit;
  2. build every kernel (trace_fwd, trace_bwd) from raytpu_torch/csrc, one
     nvcc each, all started together; print their ptxas resources;
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
     bytes against 3.35 TB/s.
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


def tree_work(scene, cfg, chunk=16384):
    """Counts of the work units above in one frame, from the plain
    version's masks: nodes visited (intensity not all zero), misses, live
    hits, shaded hits and their lights, sphere tests until the first
    shadow blocker or container, spawning nodes and their children."""
    import torch

    from raytpu_torch.ops.geometry import closest_hit, dot3, normalize, ray_sphere_t
    from raytpu_torch.ops.shading import K_SMALL_SHIFT, is_significant
    from raytpu_torch.trace import _trace_level, camera_rays

    sph, lights = scene.spheres, scene.lights
    n = sph.count
    work = dict.fromkeys(list(FWD_OPS) + list(ADJ_OPS), 0)
    gid_all = torch.arange(cfg.num_pixels, device=scene.device)

    def first_index(mask):  # (..., n) -> tests until the first True, else n
        first = torch.argmax(mask.to(torch.uint8), dim=-1) + 1
        return torch.where(mask.any(dim=-1), first, torch.full_like(first, n))

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
                        if level == cfg.max_depth:
                            break
                        spawn = live & (op < 1)
                        work["spawn"] += int(spawn.sum())
                        probe = hit.point + K_SMALL_SHIFT * dirs
                        inside = ((probe[:, None, :] - sph.pos) ** 2).sum(-1) <= (sph.radius + 1e-6) ** 2
                        work["container"] += int(first_index(inside)[spawn].sum())
                        rays = o.shape[0]
                        _, state = _trace_level(scene, *state, spawn=True)
                        alive = state[2].abs().amax(dim=1) > 0  # [refr | refl]
                        work["refr"] += int(alive[:rays].sum())
                        work["refl"] += int(alive[rays:].sum())
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
                                                 render_pixels_torch)
    from raytpu_torch.scene import (default_scene, random_scene,
                                    scene_from_leaves, scene_leaves,
                                    single_sphere_scene)
    from raytpu_torch.utils.profiling import Timer

    dev = torch.device("cuda:0")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(dev)
    print(f"phase 1: device {name} | nvidia-smi: {smi}")

    # Phase 2: build, one nvcc per source, all at once.
    kernels = (TRACE_FWD, TRACE_BWD)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:
        nvcc_s = list(pool.map(lambda k: k.build(), kernels))
    for k, s in zip(kernels, nvcc_s):
        k.function()
        print(f"phase 2: built {k.library_path().name} (nvcc {s:.2f} s)")
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line or "stack frame" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"phase 2: both built and loaded in {time.perf_counter() - t0:.2f} s")

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
         "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
