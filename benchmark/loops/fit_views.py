"""The multi-view fit loop: the gradient-fit task from several calibrated
views of one scene through the program's fit_scene(views=...), a closed
loop with one client.

The traffic's "views" are posed cameras over the configuration's scene
(reference.views.traffic_views: a turntable of poses, each rounded once
into float32), and its targets one seeded linear image a view
(reference.views.targets).  The program gets the same float32 poses as
raytpu_torch.camera.View and the reference as tensors.  Everything else
is loops/fit.py's: set-up starts fit_scene(scene, cfg, targets,
steps=restart_steps, learning_rate=the traffic's, views=..., callback=...)
with the program's other defaults; its first check_steps steps are set-up
and keep their losses, the first gradient as Adam holds it and the leaves
after the last; the window runs on in the same fit, a step the gap between
two callbacks, every restart_steps steps a new fit from the same scene.
A step renders every view, so its camera rays are V frames' (`rays`).
After the window the reference follows the checked steps over every view.
The largest opacity at the end of each fit the window finished is kept as
a reading (max_opacity), not compared.
"""

from __future__ import annotations

import gc
import time

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from benchmark import compare, inputs
from benchmark.harness import WindowClosed
from benchmark.loops.fit import _first_gradient
from benchmark.reference import tracer, views


def run(run) -> dict:
    from raytpu_torch.camera import View
    from raytpu_torch.config import RenderConfig
    from raytpu_torch.grad import fit_scene
    from raytpu_torch.parallel import make_mesh
    from raytpu_torch.scene import scene_from_leaves, scene_leaves

    traffic, render = run.traffic, run.config["render"]
    k, restart = traffic["check_steps"], traffic["restart_steps"]
    if restart < k:
        raise ValueError("restart_steps must cover the checked steps")
    cfg = RenderConfig(**render)
    leaves = inputs.jittered(inputs.scene_leaves(run.config, run.seed, run.device),
                             traffic, run.seed)
    poses = views.traffic_views(traffic["views"], run.device)
    targets = views.targets(render, traffic, run.seed, len(poses), run.device)
    cameras = [View(r.cpu().numpy(), e.cpu().numpy()) for r, e in poses]
    scene = scene_from_leaves([leaves[n] for n in tracer.LEAF_NAMES])
    mesh = make_mesh(run.device) if run.world > 1 else None

    check = {"losses": [], "grad": None, "params": None}
    times, opacity = [], []
    last = [None]

    def first_step(opt, args, kwargs):
        if check["grad"] is None:
            check["grad"] = _first_gradient(opt)

    handle = register_optimizer_step_post_hook(first_step)

    def callback(step, loss, snapshot):
        now = time.perf_counter()
        if run.window_start is None:
            check["losses"].append(float(loss))
            if len(check["losses"]) == k:
                check["params"] = dict(zip(tracer.LEAF_NAMES,
                                           scene_leaves(snapshot)))
                handle.remove()
                last[0] = run.start_window()
            return
        times.append(now - last[0])
        last[0] = now
        if step == restart - 1:  # kept on the device, read after the window
            opacity.append(snapshot.spheres.opacity.amax())
        run.mark()
        if run.stop(now, len(times)):
            raise WindowClosed

    while True:
        try:
            fit_scene(scene, cfg, targets, steps=restart,
                      learning_rate=traffic["learning_rate"], mesh=mesh,
                      callback=callback, views=cameras)
        except WindowClosed:
            break
    window_s = last[0] - run.window_start
    peak = run.peak_bytes()
    del scene, mesh
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()

    losses, grad, params = views.fit(
        leaves, render, targets, poses, k, traffic["learning_rate"],
        run.config["reference"]["block_pixels"], pixels=run.pixel_share(),
        reduce=run.all_reduce)
    ref = {"losses": losses, "grad": grad, "params": params}
    numbers = compare.training(check, ref, leaves)
    if opacity:
        numbers["max_opacity"] = float(torch.stack(opacity).max())
    return dict(iterations=len(times), window_s=window_s,
                iter_s=times, rays=len(poses) * cfg.rays_per_frame,
                peak_bytes=peak, failed=0, numbers=numbers, work=None,
                facts=dict(spheres=int(leaves["spheres.pos"].shape[0]),
                           lights=int(leaves["lights.pos"].shape[0]),
                           views=len(poses)))
