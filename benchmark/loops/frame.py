"""The frame loop: full frames through the program's render_single on one
chip, a closed loop with one client.

Set-up builds the traffic's `variants` scenes (the configuration's scene
with the traffic's jitter drawn from seeds 0 .. variants-1) and renders
each `warmup` times.  In the window iteration i renders scene (i + seed) %
variants and synchronises the device; the frame stays on the device.  So
every seed runs the same mix of frames, in another order.  The benchmark
keeps the frame of iteration seed % keep_within and the last one, and
after the window compares both with the reference's frames of their
scenes.
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark import compare, inputs
from benchmark.reference import tracer
from benchmark.roofline import new_work


def run(run) -> dict:
    from raytpu_torch.config import RenderConfig
    from raytpu_torch.render import render_single
    from raytpu_torch.scene import scene_from_leaves

    if run.world > 1:
        raise ValueError("the frame loop runs on one chip")
    traffic, render = run.traffic, run.config["render"]
    cfg = RenderConfig(**render)
    base = inputs.scene_leaves(run.config, run.seed, run.device)
    variants = [inputs.jittered(base, traffic, v) for v in range(traffic["variants"])]
    scenes = [scene_from_leaves([v[n] for n in tracer.LEAF_NAMES]) for v in variants]

    def frame(i):
        img = render_single(scenes[(i + run.seed) % len(scenes)], cfg)
        run.sync()
        return img

    for i in range(traffic["warmup"] * len(scenes)):
        frame(i)
    keep_at = run.seed % traffic["keep_within"]
    kept, times = (None, None), []
    last = run.start_window()
    while True:
        i = len(times)
        img = frame(i)
        now = time.perf_counter()
        if i == keep_at:
            kept = (i, img)
        times.append(now - last)
        last = now
        run.mark()
        if run.stop(now, len(times)):
            break
    window_s = last - run.window_start
    peak = run.peak_bytes()
    frames = [(j, f.reshape(-1, 3)) for j, f in (kept, (i, img)) if f is not None]
    del scenes, img, kept
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()

    # The references of the kept frames' scenes; a traced run counts the
    # work units of every scene's frame, for the mean frame of the mix.
    block = run.config["reference"]["block_pixels"]
    wanted = {(j + run.seed) % len(variants) for j, _ in frames}
    work, refs = (new_work() if run.trace else None), {}
    for v, leaves in enumerate(variants):
        if v in wanted or work is not None:
            refs[v] = tracer.render(leaves, render, block, work=work)
    if work is not None:
        work = {k: n / len(variants) for k, n in work.items()}
    numbers = {}
    for j, f in frames:
        got = compare.frame(f, refs[(j + run.seed) % len(variants)],
                            traffic["off_threshold"])
        numbers = {k: max(v, numbers.get(k, v)) for k, v in got.items()}
    return dict(iterations=len(times), window_s=window_s,
                iter_s=times, rays=cfg.rays_per_frame, peak_bytes=peak,
                failed=0, numbers=numbers, work=work,
                facts=dict(spheres=int(base["spheres.pos"].shape[0]),
                           lights=int(base["lights.pos"].shape[0])))
