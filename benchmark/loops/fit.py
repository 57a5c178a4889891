"""The fit loop: the gradient-fit task (BASELINE config 4) through the
program's fit_scene, a closed loop with one client.

Set-up builds the scene and target from the seed and starts
fit_scene(scene, cfg, target, steps=restart_steps, callback=...) with the
program's defaults (backend "auto", its Adam at its rate, its ladder, its
pixel split over the ranks).  Its first check_steps steps are set-up: the
benchmark keeps their losses, the first gradient as the optimizer holds
it after one step (Adam's exp_avg / (1 - beta1)), and the leaves after
the last of them.  The window then starts on the same fit and runs on: a
step is the gap between two callbacks (each after fit_scene's loss
read-back, which waits for the optimizer's update), and every
restart_steps steps the fit starts again from the same scene, so that a
faster program does more of the same fits.  After the window the
reference follows the checked steps from the same scene and target.
"""

from __future__ import annotations

import gc
import time

import torch
from torch.optim.optimizer import register_optimizer_step_post_hook

from benchmark import compare, inputs
from benchmark.roofline import new_work
from benchmark.harness import WindowClosed
from benchmark.reference import tracer


def _first_gradient(opt) -> dict:
    """The gradient the optimizer took in its first step, from its state:
    Adam's exp_avg / (1 - beta1), or the parameter's .grad for an
    optimizer that keeps no first moment."""
    out = {}
    group = opt.param_groups[0]
    for name, p in zip(tracer.LEAF_NAMES, group["params"]):
        st = opt.state.get(p, {})
        if "exp_avg" in st:
            out[name] = (st["exp_avg"] / (1 - group["betas"][0])).detach().clone()
        else:
            out[name] = p.grad.detach().clone()
    return out


def run(run) -> dict:
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
    target = inputs.target(render, traffic, run.seed, run.device)
    scene = scene_from_leaves([leaves[n] for n in tracer.LEAF_NAMES])
    mesh = make_mesh(run.device) if run.world > 1 else None

    check = {"losses": [], "grad": None, "params": None}
    times = []
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
        run.mark()
        if run.stop(now, len(times)):
            raise WindowClosed

    while True:
        try:
            fit_scene(scene, cfg, target, steps=restart, mesh=mesh,
                      callback=callback)
        except WindowClosed:
            break
    window_s = last[0] - run.window_start
    peak = run.peak_bytes()
    del scene, mesh
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()

    work = new_work() if run.trace else None
    losses, grad, params = tracer.fit(
        leaves, render, target, k, traffic["learning_rate"],
        run.config["reference"]["block_pixels"], pixels=run.pixel_share(),
        reduce=run.all_reduce, work=work)
    ref = {"losses": losses, "grad": grad, "params": params}
    numbers = compare.training(check, ref, leaves)
    return dict(iterations=len(times), window_s=window_s,
                iter_s=times, rays=cfg.rays_per_frame, peak_bytes=peak,
                failed=0, numbers=numbers, work=work,
                facts=dict(spheres=int(leaves["spheres.pos"].shape[0]),
                           lights=int(leaves["lights.pos"].shape[0])))
