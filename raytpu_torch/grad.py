"""Differentiable rendering: losses, the scene gradient, the gradient-fit
task and the finite-difference checker (the counterpart of raytpu.grad).

Backends, as resolve_train_backend resolves them:
  * "cuda"      — the kernel pair: the forward kernel renders, the backward
                  kernel differentiates (kernels.trace_cuda.RenderPixelsFn);
                  a CUDA scene only.
  * "wavefront" — the differentiable wavefront, raytpu's large-scene
                  training path: per level the level kernel forward and its
                  backward (K3, K4), between levels the compaction and its
                  transpose (K5, K6), autograd through the glue
                  (kernels.wavefront); on the CPU their plain versions.  A
                  live ray dropped past the per-level capacity takes no
                  gradient and biases it invisibly, so every call enforces
                  the drop counter (on_drop="raise" by default), and
                  fit_scene climbs the capacity ladder instead.
  * "torch"     — torch.autograd through the eager tracer, on any device.
  * "auto"      — on a CUDA scene the wavefront where the backward kernel
                  cannot take the scene (its shared-memory bound) or the
                  training crossover measured on the card says so (frames
                  of at least 640x480 3x3 camera rays, render._wf_wins_train),
                  else "cuda"; "torch" on the CPU.

Non-differentiable events are handled as in raytpu: the closest-hit,
container, shadow and significance selections are constants of the
derivative, and masked square roots and divisions are guarded so that no
gradient is NaN.  The sharded training path (a mesh, interleave) is not
ported yet (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels.trace_cuda import (SMEM_BYTES, _bwd_shared_bytes,
                                             render_pixels_cuda_ad)
from raytpu_torch.kernels.wavefront import render_pixels_wavefront
from raytpu_torch.render import (WF_AUTO_CHUNK_TRAIN, _report_drops,
                                 _warn_escalate, _wf_auto_trials,
                                 _wf_wins_train, resolve_backend)
from raytpu_torch.scene import Scene, scene_from_leaves, scene_leaves
from raytpu_torch.trace import render_pixels

# A single wavefront training call's capacity when the caller names none:
# raytpu's loss_and_grad_wavefront default, above every measured frontier.
# fit_scene runs the ladder instead.
WF_TRAIN_CAPACITY = 2.0


def resolve_train_backend(backend: str, scene, cfg: RenderConfig) -> str:
    """The training backend for `scene` at `cfg`: "auto" on a CUDA scene is
    the wavefront where the backward kernel cannot stage the scene (8 (12N
    + 6L + 5) bytes of shared memory above SMEM_BYTES) or where the
    measured training crossover says so, else "cuda"."""
    if backend == "auto" and scene.device.type == "cuda":
        n, nl = scene.spheres.count, scene.lights.count
        if _bwd_shared_bytes(n, nl) > SMEM_BYTES or _wf_wins_train(cfg):
            return "wavefront"
        return "cuda"
    return resolve_backend(backend, scene.device)


def _render_ad(scene, cfg: RenderConfig, gid, backend: str,
               wf_opts: dict | None = None, info: dict | None = None):
    """Differentiable render of the pixel ids `gid` (None: the whole frame).
    The wavefront's drop counter goes to info["dropped"] (a 0-d tensor on
    the device) for the caller to enforce; without `info` it is enforced
    here, since no caller could see it."""
    backend = resolve_train_backend(backend, scene, cfg)
    if backend in ("cuda", "wavefront"):
        if gid is not None:
            raise ValueError(f"backend {backend!r} renders the whole frame; "
                             f"pass backend='torch' to differentiate a pixel "
                             f"subset")
        if backend == "cuda":
            return render_pixels_cuda_ad(scene, cfg)
        opts = {"chunk_rays": WF_AUTO_CHUNK_TRAIN,
                "capacity_factor": WF_TRAIN_CAPACITY, **(wf_opts or {})}
        img, i = render_pixels_wavefront(scene, cfg, return_info=True, **opts)
        if info is None:
            _report_drops(i["dropped"], "raise")
        else:
            info.update(dropped=i["dropped"], wf_opts=opts)
        return img
    if gid is None:
        gid = torch.arange(cfg.num_pixels, dtype=torch.int64,
                           device=scene.device)
    return render_pixels(scene, cfg, gid)


def image_loss(scene, cfg: RenderConfig, target_flat, gid=None,
               backend: str = "auto"):
    """Mean-squared error between the rendered pixels and a (P, 3) linear
    target.  With `gid`, only that pixel block is rendered and compared
    against target_flat[gid] (torch backend only)."""
    target = target_flat if gid is None else target_flat[gid]
    err = _render_ad(scene, cfg, gid, backend) - target
    return torch.mean(err * err)


def exposure_image_loss(scene, cfg: RenderConfig, target_flat, gid=None,
                        backend: str = "auto"):
    """MSE against a tone-mapped (P, 3) target (byte values / 255) with the
    exposure profiled out in closed form: e* = <pred, t> / <pred, pred> is
    substituted differentiably, so the loss measures shape, not the render's
    global scale (see raytpu.grad.exposure_image_loss)."""
    target = target_flat if gid is None else target_flat[gid]
    pred = _render_ad(scene, cfg, gid, backend)
    e = torch.sum(pred * target) / (torch.sum(pred * pred) + 1e-30)
    r = e * pred - target
    return torch.mean(r * r)


def _value_and_grad(fn, scene):
    """(fn(scene), its gradient as a Scene) by torch.autograd."""
    leaves = [t.detach().requires_grad_(True) for t in scene_leaves(scene)]
    with torch.enable_grad():
        value = fn(scene_from_leaves(leaves))
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    return value.detach(), scene_from_leaves(
        [torch.zeros_like(t) if d is None else d for t, d in zip(leaves, grads)])


def loss_and_grad(scene, cfg: RenderConfig, target_flat, backend: str = "auto"):
    """Single-device image_loss and its gradient with respect to every
    scene leaf: (loss, gradient Scene).  On a CUDA scene "auto" runs the
    forward and backward kernels, or the wavefront where
    resolve_train_backend says so (a drop then raises); on the CPU,
    autograd of the eager tracer."""
    return _value_and_grad(
        lambda s: image_loss(s, cfg, target_flat, backend=backend), scene)


def loss_and_grad_wavefront(scene, cfg: RenderConfig, target_flat,
                            chunk_rays: int = WF_AUTO_CHUNK_TRAIN,
                            capacity_factor: float = WF_TRAIN_CAPACITY,
                            on_drop: str = "raise", return_info: bool = False):
    """The MSE against a (P, 3) target and its scene gradient through the
    differentiable wavefront (raytpu.grad.loss_and_grad_wavefront): the
    large-scene training path, no sphere bound below the level kernel's,
    dead subtrees skipped per ray.  On a CUDA scene the levels run K3 and
    K4 and the compactions K5 and K6; on the CPU their plain versions.

    `chunk_rays` and `capacity_factor` are render_pixels_wavefront's.  A
    capacity that drops live rays biases the gradient, invisibly in the
    loss (a dropped subtree takes no cotangent), and the zero-drop capacity
    moves as a fit moves the geometry, so the drop count is read on every
    call and reported per `on_drop`: "raise" (default), "warn" or
    "ignore".  Returns (loss, gradient Scene), with `return_info` also
    {'dropped': int, 'wf_opts': the options used}."""
    info = {}
    opts = dict(chunk_rays=chunk_rays, capacity_factor=capacity_factor)

    def loss(s):
        err = _render_ad(s, cfg, None, "wavefront", opts, info) - target_flat
        return torch.mean(err * err)

    value, grads = _value_and_grad(loss, scene)
    info["dropped"] = _report_drops(info["dropped"], on_drop)
    return (value, grads, info) if return_info else (value, grads)


def loss_and_grad_sharded(*args, **kwargs):
    raise NotImplementedError(
        "the sharded training step is not ported yet (ROADMAP Queue 1 item 7)")


def fit_scene(scene, cfg: RenderConfig, target_flat, steps: int = 100,
              learning_rate: float = 1e-2, mesh=None, optimizer=None,
              callback=None, trainable=None, backend: str = "auto",
              interleave: bool = False, wf_opts: dict | None = None,
              on_drop: str = "raise"):
    """Gradient-fit task (BASELINE config 4): optimise the scene's leaves to
    match a (P, 3) linear target.  Returns (scene, losses).

    `optimizer`: a function from the list of 11 leaf tensors to a
    torch.optim.Optimizer over them (default Adam at `learning_rate`).
    `trainable`: a Scene with a bool per leaf; the gradients of False
    leaves are zeroed, as in raytpu.grad.fit_scene.  `backend` as in
    resolve_train_backend.

    The wavefront reads every step's drop count.  Without a
    capacity_factor in `wf_opts` (chunk_rays, capacity_factor) it climbs the training ladder (render.WF_AUTO_LADDER_TRAIN): a step
    that drops is discarded and re-run at the next capacity (the step is
    stateless, so the retry is exact), and the fit stays at that capacity.
    Drops left at the top of the ladder, or at an explicit capacity, go
    through `on_drop` ("raise" by default: a crashed step beats a biased
    gradient).  The dense paths drop nothing.  `mesh` and `interleave`
    belong to the sharded path, not ported yet, and raise."""
    if mesh is not None or interleave:
        raise NotImplementedError(
            "fitting over a mesh is not ported yet (ROADMAP Queue 1 item 7)")
    backend = resolve_train_backend(backend, scene, cfg)
    params = [t.detach().clone().requires_grad_(True)
              for t in scene_leaves(scene)]
    if optimizer is None:
        opt = torch.optim.Adam(params, lr=learning_rate)
    else:
        opt = optimizer(params)
    mask = ([True] * len(params) if trainable is None
            else [bool(m) for m in scene_leaves(trainable)])
    def snapshot():  # the optimizer updates the leaves in place
        return scene_from_leaves([p.detach().clone() for p in params])

    trials = _wf_auto_trials(wf_opts, train=True)
    rung = 0
    losses = []
    for step in range(steps):
        while True:
            if backend == "wavefront":
                loss, grads, info = loss_and_grad_wavefront(
                    snapshot(), cfg, target_flat, on_drop="ignore",
                    return_info=True, **trials[rung])
            else:
                loss, grads = loss_and_grad(snapshot(), cfg, target_flat, backend)
                info = dict(dropped=0)
            if info["dropped"] == 0:
                break
            if rung + 1 == len(trials):
                _report_drops(info["dropped"], on_drop)
                break
            _warn_escalate(info["dropped"], trials[rung], trials[rung + 1])
            rung += 1  # discard the biased step and re-run it
        for p, g, m in zip(params, scene_leaves(grads), mask):
            p.grad = g if m else torch.zeros_like(g)
        opt.step()
        losses.append(float(loss))
        if callback is not None:
            callback(step, losses[-1], snapshot())
    return snapshot(), losses


def finite_difference_check(fn, scene: Scene, eps: float = 1e-3,
                            max_coords: int = 4):
    """Central-difference check of the scalar `fn(scene)` against its
    autograd gradient.  Probes up to `max_coords` coordinates of each leaf
    and returns (leaf index, coordinate, analytic, numeric) rows, leaves in
    scene_leaves order (that of raytpu.grad.finite_difference_check)."""
    _, grads = _value_and_grad(fn, scene)
    leaves = list(scene_leaves(scene))
    rows = []
    for li, (leaf, gleaf) in enumerate(zip(leaves, scene_leaves(grads))):
        flat = leaf.detach().cpu().numpy().astype(np.float64).ravel()
        gflat = gleaf.detach().cpu().numpy().astype(np.float64).ravel()
        for ci in range(min(flat.size, max_coords)):
            def perturbed(delta):
                f = flat.copy()
                f[ci] += delta
                moved = list(leaves)
                moved[li] = torch.tensor(f.reshape(tuple(leaf.shape)),
                                         dtype=torch.float32, device=leaf.device)
                with torch.no_grad():
                    return float(fn(scene_from_leaves(moved)))
            numeric = (perturbed(eps) - perturbed(-eps)) / (2 * eps)
            rows.append((li, ci, float(gflat[ci]), numeric))
    return rows
