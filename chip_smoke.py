#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (raytpu_torch) once on one CUDA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero before the
result lines):
  1. a CUDA device is present; print its nvidia-smi name and power limit;
  2. build every kernel of the render path from raytpu_torch/csrc;
  3. hold each kernel against its plain PyTorch version on the card, under
     the forward contract of tests/test_pallas.py (outlier fraction <= 1% at
     1e-2*scale, mean abs diff < 1e-3*scale);
  4. anchor to the JAX reference without JAX: the kernel against the
     linear golden written by raytpu.trace (tests/goldens);
  5. the main path: raytpu_torch.cli.main(["-o", <tmp>.ppm]), the golden
     800x600 depth-5 3x3 render with --backend auto, counting the kernel's
     launches and holding the image against the plain version;
  6. time config 3 and the golden frame, kernel against plain version, with
     CUDA events (median of 5 after 1 warm-up).
The last two lines are the kernels JSON and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDENS = os.path.join(ROOT, "tests", "goldens")


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


def nvidia_smi_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


def median_ms(timer, name):
    return float(np.median(timer.summary()[name])) * 1e3


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import raytpu_torch.render as render
    from raytpu_torch import cli
    from raytpu_torch.config import BENCH_CONFIGS, RenderConfig
    from raytpu_torch.image import read_ppm, tone_map
    from raytpu_torch.kernels.trace_cuda import (TRACE_FWD, render_pixels_cuda,
                                                 render_pixels_torch)
    from raytpu_torch.scene import default_scene, random_scene, single_sphere_scene
    from raytpu_torch.utils.profiling import Timer

    dev = torch.device("cuda:0")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(dev)
    print(f"phase 1: device {name} | nvidia-smi: {smi}")

    # Phase 2: build.
    t0 = time.perf_counter()
    nvcc_s = TRACE_FWD.build()
    TRACE_FWD.function()
    print(f"phase 2: built {TRACE_FWD.library_path().name} in "
          f"{time.perf_counter() - t0:.2f} s (nvcc {nvcc_s:.2f} s)")
    for line in TRACE_FWD.build_log.splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            print(f"  ptxas: {line.strip()}")

    # Phase 3: kernel vs plain on the card.
    ds = default_scene(device=dev)
    cases = [
        ("default 64x32 a1 d0", ds, RenderConfig(width=64, height=32, max_depth=0, alias_factor=1), {}, 0.01, 1e-3),
        ("default 64x32 a1 d1", ds, RenderConfig(width=64, height=32, max_depth=1, alias_factor=1), {}, 0.01, 1e-3),
        ("default 64x32 a1 d3", ds, RenderConfig(width=64, height=32, max_depth=3, alias_factor=1), {}, 0.01, 1e-3),
        ("default 64x32 a3 d2", ds, RenderConfig(width=64, height=32, max_depth=2, alias_factor=3), {}, 0.01, 1e-3),
        ("default 50x17 a1 d1", ds, RenderConfig(width=50, height=17, max_depth=1, alias_factor=1), {}, 0.01, 1e-3),
        ("random32 64x16 a1 d1", random_scene(32, seed=3, device=dev),
         RenderConfig(width=64, height=16, max_depth=1, alias_factor=1), {}, 0.01, 1e-3),
        # test_pallas.py:75-76's looser bounds for a frame of silhouettes.
        ("random256 64x8 a1 d1", random_scene(256, seed=3, device=dev),
         RenderConfig(width=64, height=8, max_depth=1, alias_factor=1), {}, 0.05, 3e-3),
        ("single 64x32 a1 d0", single_sphere_scene(device=dev),
         RenderConfig(width=64, height=32, max_depth=0, alias_factor=1), {}, 0.0, 1e-3),
        ("default 64x32 a1 d2 offset=5 stride=3", ds,
         RenderConfig(width=64, height=32, max_depth=2, alias_factor=1),
         dict(offset=5, stride=3, count=600), 0.01, 1e-3),
    ]
    for label, scene, cfg, kw, frac, mean in cases:
        k = render_pixels_cuda(scene, cfg, **kw)
        torch.cuda.synchronize()
        p = render_pixels_torch(scene, cfg, **kw)
        s = contract(k.cpu(), p.cpu(), frac, mean)
        print(f"phase 3: {label}: outliers {s['outliers']:.5f} (<= {frac}) "
              f"mean/scale {s['mean_over_scale']:.3e} (< {mean}) "
              f"max_abs_err {s['max_abs_err']:.3e}")

    # Phase 4: anchor to the JAX reference's golden, written by raytpu.trace.
    cfg = RenderConfig(width=160, height=120, max_depth=4, alias_factor=3)
    img = render_pixels_cuda(ds, cfg).reshape(120, 160, 3).cpu().numpy()
    ref = np.load(os.path.join(GOLDENS, "default_160x120_d4_linear.npy"))
    s = contract(img, ref)
    exact = float((tone_map(img) == read_ppm(
        os.path.join(GOLDENS, "default_160x120_d4.ppm"))).mean())
    print(f"phase 4: golden 160x120 d4 a3: outliers {s['outliers']:.5f} "
          f"mean/scale {s['mean_over_scale']:.3e} max_abs_err "
          f"{s['max_abs_err']:.3e}; PPM byte-exact fraction {exact:.6f}")

    # Phase 5: the main path through the CLI, as a user runs it.
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
        check(launches >= 1, "the main path did not launch trace_fwd")
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
    print(f"phase 5: cli golden 800x600 d5 a3: trace_fwd launches {launches}; "
          f"vs plain outliers {s_main['outliers']:.5f} mean/scale "
          f"{s_main['mean_over_scale']:.3e} max_abs_err {s_main['max_abs_err']:.3e}")

    # Phase 6: time kernel and plain version in turns on one card.
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
            print(f"phase 6: {key} {cfg.width}x{cfg.height} d{cfg.max_depth} "
                  f"a{cfg.alias_factor} {label}: {ms:.3f} ms "
                  f"{cfg.rays_per_frame / ms / 1e3:.2f} camera Mrays/s")

    kms, pms = times["golden"]  # the main path's frame
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "trace_fwd", "route": "cuda",
        "source": os.path.relpath(str(TRACE_FWD.source), ROOT),
        "replaces": "raytpu/kernels/trace_pallas.py:798",
        "launches": launches, "max_abs_err": s_main["max_abs_err"],
        "ms": kms, "plain_ms": pms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
