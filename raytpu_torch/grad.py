"""Differentiable rendering: losses, the scene gradient, the gradient-fit
task and the finite-difference checker (the counterpart of raytpu.grad).

Backends, as raytpu_torch.render resolves them:
  * "cuda"  — the kernel pair: the forward kernel renders, the backward
              kernel differentiates (kernels.trace_cuda.RenderPixelsFn);
              a CUDA scene only.
  * "torch" — torch.autograd through the eager tracer, on any device.
  * "auto"  — "cuda" on a CUDA scene, "torch" on the CPU.

Non-differentiable events are handled as in raytpu: the closest-hit,
container, shadow and significance selections are constants of the
derivative, and masked square roots and divisions are guarded so that no
gradient is NaN.  The wavefront and sharded training paths are not ported
yet (ROADMAP Queue 1 items 6 and 7).
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels.trace_cuda import render_pixels_cuda_ad
from raytpu_torch.render import resolve_backend
from raytpu_torch.scene import Scene, scene_from_leaves, scene_leaves
from raytpu_torch.trace import render_pixels


def _render_ad(scene, cfg: RenderConfig, gid, backend: str):
    """Differentiable render of the pixel ids `gid` (None: the whole frame)."""
    if backend == "wavefront":
        raise NotImplementedError(
            "the differentiable wavefront tracer is not ported yet (ROADMAP "
            "Queue 1 item 6)")
    if resolve_backend(backend, scene.device) == "cuda":
        if gid is not None:
            raise ValueError("the kernel pair renders the whole frame; pass "
                             "backend='torch' to differentiate a pixel subset")
        return render_pixels_cuda_ad(scene, cfg)
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
    forward and backward kernels; on the CPU, autograd of the eager
    tracer."""
    return _value_and_grad(
        lambda s: image_loss(s, cfg, target_flat, backend=backend), scene)


def loss_and_grad_wavefront(*args, **kwargs):
    raise NotImplementedError(
        "the differentiable wavefront tracer is not ported yet (ROADMAP "
        "Queue 1 item 6)")


def loss_and_grad_sharded(*args, **kwargs):
    raise NotImplementedError(
        "the sharded training step is not ported yet (ROADMAP Queue 1 item 7)")


def fit_scene(scene, cfg: RenderConfig, target_flat, steps: int = 100,
              learning_rate: float = 1e-2, mesh=None, optimizer=None,
              callback=None, trainable=None, backend: str = "auto",
              interleave: bool = False, wf_opts: dict | None = None):
    """Gradient-fit task (BASELINE config 4): optimise the scene's leaves to
    match a (P, 3) linear target.  Returns (scene, losses).

    `optimizer`: a function from the list of 11 leaf tensors to a
    torch.optim.Optimizer over them (default Adam at `learning_rate`).
    `trainable`: a Scene with a bool per leaf; the gradients of False
    leaves are zeroed, as in raytpu.grad.fit_scene.  `backend` as in
    loss_and_grad.  The dense path drops no ray, so there is no capacity
    ladder; `mesh`, `interleave`, `wf_opts` and backend="wavefront" belong
    to paths not ported yet and raise."""
    if mesh is not None or interleave:
        raise NotImplementedError(
            "fitting over a mesh is not ported yet (ROADMAP Queue 1 item 7)")
    if wf_opts is not None or backend == "wavefront":
        raise NotImplementedError(
            "fitting through the wavefront tracer is not ported yet (ROADMAP "
            "Queue 1 item 6)")
    backend = resolve_backend(backend, scene.device)
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

    losses = []
    for step in range(steps):
        loss, grads = loss_and_grad(snapshot(), cfg, target_flat, backend)
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
