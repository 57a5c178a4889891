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
  * "auto"      — on a CUDA scene the wavefront where the kernel pair
                  cannot take the scene (a depth above MAX_DEPTH, more than
                  MAX_SPHERES spheres or MAX_LIGHTS lights, tables beyond
                  the backward's shared memory) or the training crossover
                  measured on the card says so (frames of at least 640x480
                  3x3 camera rays and N x depth >= 256,
                  render._wf_wins_train), else "cuda";
                  "torch" on the CPU, and "torch" for a pixel subset `gid`
                  (the whole-frame kernels do not take one).

Non-differentiable events are handled as in raytpu: the closest-hit,
container, shadow and significance selections are constants of the
derivative, and masked square roots and divisions are guarded so that no
gradient is NaN.

pack_target and loss_and_grad_packed are raytpu's packed-tile training step:
a target packed in raytpu's tiled layout, and loss_and_grad on its unpacked
view.

loss_and_grad_sharded and fit_scene(mesh=) train over the ranks of a
process group (raytpu_torch.parallel): the scene replicated, each rank the
gradient of its pixel set's share of the loss, and one all-reduce of the
gradient, the loss and the drop count together.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels.trace_cuda import (SMEM_BYTES, _bwd_shared_bytes,
                                             dense_takes, pack_pixel_tiles,
                                             render_pixels_cuda_ad,
                                             render_pixels_torch,
                                             unpack_pixel_tiles)
from raytpu_torch.kernels.wavefront import render_pixels_wavefront
from raytpu_torch.parallel.mesh import Mesh, all_reduce_sum, make_mesh, pixel_set
from raytpu_torch.render import (WF_AUTO_CHUNK_TRAIN, _report_drops,
                                 _warn_escalate, _wf_auto_trials,
                                 _wf_wins_train, resolve_backend)
from raytpu_torch.scene import Scene, scene_from_leaves, scene_leaves
from raytpu_torch.trace import render_pixels

# A single wavefront training call's capacity when the caller names none:
# raytpu's loss_and_grad_wavefront default, above every measured frontier.
# fit_scene runs the ladder instead.
WF_TRAIN_CAPACITY = 2.0


def card_train_backend(scene, cfg: RenderConfig) -> str:
    """What "auto" trains `scene` at `cfg` through on a CUDA device,
    wherever the scene lies: the wavefront where the kernel pair does not
    take the scene (a depth above MAX_DEPTH, more than MAX_SPHERES spheres
    or MAX_LIGHTS lights, or 8 (12N + 6L + 5) bytes of shared memory above
    SMEM_BYTES for the backward kernel) or where the measured training
    crossover says so, else "cuda"."""
    n, nl = scene.spheres.count, scene.lights.count
    if (not dense_takes(scene, cfg) or _bwd_shared_bytes(n, nl) > SMEM_BYTES
            or _wf_wins_train(n, cfg)):
        return "wavefront"
    return "cuda"


def resolve_train_backend(backend: str, scene, cfg: RenderConfig,
                          gid=None) -> str:
    """The training backend for `scene` at `cfg`: "auto" on a CUDA scene is
    card_train_backend's choice.  With a pixel subset `gid`, "auto" is
    "torch": the kernels and the wavefront differentiate whole frames."""
    if backend == "auto" and gid is not None:
        return "torch"
    if backend == "auto" and scene.device.type == "cuda":
        return card_train_backend(scene, cfg)
    return resolve_backend(backend, scene)


def _render_ad(scene, cfg: RenderConfig, gid, backend: str,
               wf_opts: dict | None = None, info: dict | None = None,
               pixels=None):
    """Differentiable render of the pixel ids `gid` (None: the whole frame),
    or of the pixel set `pixels` = (offset, count, stride), a rank's shard,
    on any backend; "auto" is resolved for the frame either way, so that
    every rank resolves alike.  The wavefront's drop counter goes to
    info["dropped"] (a 0-d tensor on the device) for the caller to enforce;
    without `info` it is enforced here, since no caller could see it."""
    backend = resolve_train_backend(backend, scene, cfg, gid)
    if backend in ("cuda", "wavefront"):
        if gid is not None:
            raise ValueError(f"backend {backend!r} renders the whole frame; "
                             f"pass backend='torch' to differentiate a pixel "
                             f"subset")
        offset, count, stride = (0, None, 1) if pixels is None else pixels
        if backend == "cuda":
            return render_pixels_cuda_ad(scene, cfg, offset, count, stride)
        opts = {"chunk_rays": WF_AUTO_CHUNK_TRAIN,
                "capacity_factor": WF_TRAIN_CAPACITY, **(wf_opts or {})}
        img, i = render_pixels_wavefront(scene, cfg, return_info=True,
                                         offset=offset, count=count,
                                         shard_stride=stride, **opts)
        if info is None:
            _report_drops(i["dropped"], "raise")
        else:
            info.update(dropped=i["dropped"], wf_opts=opts)
        return img
    if pixels is not None:
        return render_pixels_torch(scene, cfg, *pixels)
    if gid is None:
        gid = torch.arange(cfg.num_pixels, dtype=torch.int64,
                           device=scene.device)
    return render_pixels(scene, cfg, gid)


def image_loss(scene, cfg: RenderConfig, target_flat, gid=None,
               backend: str = "auto"):
    """Mean-squared error between the rendered pixels and a (P, 3) linear
    target.  With `gid`, only those pixels are rendered and compared
    against target_flat[gid], through the eager tracer ("auto" resolves to
    "torch"; an explicit "cuda" or "wavefront" raises)."""
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
    autograd of the eager tracer.  loss_and_grad_sharded over a world of
    one, whatever process group is initialised."""
    return loss_and_grad_sharded(scene, cfg, target_flat,
                                 Mesh(0, 1, scene.device), backend)


def pack_target(cfg: RenderConfig, target_flat):
    """A (P, 3) target in raytpu's tiled layout (3, rows, LANES), the tail
    zero: pack it once per fit, outside the step (the counterpart of
    raytpu.grad.pack_target)."""
    return pack_pixel_tiles(target_flat, cfg.num_pixels)


def loss_and_grad_packed(scene, cfg: RenderConfig, target_packed):
    """The MSE against a pack_target target and its scene gradient:
    (loss, gradient Scene), as loss_and_grad returns them (the counterpart
    of raytpu.grad.loss_and_grad_pallas_packed; the port says cuda where
    raytpu says pallas).  raytpu's masked sum over the tiles, divided by
    3P, is the flat MSE over the target's real lanes, so this is
    loss_and_grad on the unpacked view: the tiled layout answers the TPU's
    lanes and buys nothing here.  On a CUDA scene the kernel pair (one
    forward and one backward launch; a scene they do not take raises, as
    raytpu's step has no other path); on the CPU autograd of the eager
    tracer."""
    backend = "cuda" if scene.device.type == "cuda" else "torch"
    return loss_and_grad(scene, cfg, unpack_pixel_tiles(target_packed,
                                                        cfg.num_pixels),
                         backend)


def loss_and_grad_wavefront(scene, cfg: RenderConfig, target_flat,
                            chunk_rays: int = WF_AUTO_CHUNK_TRAIN,
                            capacity_factor: float = WF_TRAIN_CAPACITY,
                            on_drop: str = "raise", return_info: bool = False):
    """The MSE against a (P, 3) target and its scene gradient through the
    differentiable wavefront (raytpu.grad.loss_and_grad_wavefront): the
    large-scene training path, any depth and any number of spheres and
    lights, dead subtrees skipped per ray.  On a CUDA scene the levels run K3 and
    K4 and the compactions K5 and K6; on the CPU their plain versions.

    `chunk_rays` and `capacity_factor` are render_pixels_wavefront's.  A
    capacity that drops live rays biases the gradient, invisibly in the
    loss (a dropped subtree takes no cotangent), and the zero-drop capacity
    moves as a fit moves the geometry, so the drop count is read on every
    call and reported per `on_drop`: "raise" (default), "warn" or
    "ignore".  Returns (loss, gradient Scene), with `return_info` also
    {'dropped': int, 'wf_opts': the options used}.  loss_and_grad_sharded
    over a world of one."""
    return loss_and_grad_sharded(
        scene, cfg, target_flat, Mesh(0, 1, scene.device), "wavefront",
        wf_opts=dict(chunk_rays=chunk_rays, capacity_factor=capacity_factor),
        on_drop=on_drop, return_info=return_info)


def loss_and_grad_sharded(scene, cfg: RenderConfig, target_flat, mesh=None,
                          backend: str = "auto", interleave: bool = False,
                          wf_opts: dict | None = None, on_drop: str = "raise",
                          return_info: bool = False):
    """The MSE against a (P, 3) target and its scene gradient, with the
    pixels split over the ranks of `mesh` (default: make_mesh on the
    scene's device) and the scene replicated: (loss, gradient Scene), the
    same on every rank, with `return_info` also {'dropped': int} and, for
    the wavefront, {'wf_opts': the options used}.

    P must divide by the number of ranks.  Each rank renders its pixel set
    (parallel.pixel_set; `interleave` as in render_sharded) through
    `backend`, resolved for the frame as resolve_train_backend resolves it,
    and takes the gradient of its share of the frame's mean, sum(err^2) /
    (3P); one all-reduce then sums the gradient, the loss and the
    wavefront's drop count in one buffer (none in a world of one).  A
    dropped live ray biases the gradient, so the summed count is reported
    per `on_drop` ("raise" by default) on every rank alike.  `wf_opts`
    (chunk_rays, capacity_factor, streams) tune the wavefront."""
    mesh = make_mesh(scene.device) if mesh is None else mesh
    p = cfg.num_pixels
    if p % mesh.size:
        raise ValueError(f"{p} pixels do not divide over {mesh.size} ranks")
    backend = resolve_train_backend(backend, scene, cfg)
    pixels = pixel_set(mesh, cfg, interleave)
    offset, count, stride = pixels
    target = target_flat[offset::stride][:count]
    info = {}

    def loss(s):
        err = _render_ad(s, cfg, None, backend, wf_opts, info, pixels) - target
        return torch.sum(err * err) / (3 * p)

    value, grads = _value_and_grad(loss, scene)
    # The gradient leaves, the loss and (the wavefront's) the drop count.
    parts = [*scene_leaves(grads), value] + (
        [info["dropped"]] if "dropped" in info else [])
    if mesh.group is not None:
        # float64: the drop count stays exact past 2^24, and the sum of the
        # ranks' shares rounds once into float32.
        buf = all_reduce_sum(mesh, torch.cat([t.reshape(-1).double()
                                              for t in parts]))
        parts = [b.reshape(t.shape).to(t.dtype) for b, t in
                 zip(torch.split(buf, [t.numel() for t in parts]), parts)]
    # The dense backends drop nothing, and their step reads nothing back.
    info["dropped"] = (_report_drops(int(parts.pop()), on_drop)
                       if "dropped" in info else 0)
    loss_value = parts.pop()
    grads = scene_from_leaves(parts)
    return (loss_value, grads, info) if return_info else (loss_value, grads)


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
    capacity_factor in `wf_opts` (chunk_rays, capacity_factor, streams) it
    climbs the training ladder (render.WF_AUTO_LADDER_TRAIN): a step
    that drops is discarded and re-run at the next capacity (the step is
    stateless, so the retry is exact), and the fit stays at that capacity.
    Drops left at the top of the ladder, or at an explicit capacity, go
    through `on_drop` ("raise" by default: a crashed step beats a biased
    gradient).  The dense paths drop nothing.

    Every step is loss_and_grad_sharded's over `mesh` (default: a world of
    one on the scene's device; `interleave` as there): each rank holds the
    whole scene and applies the same summed gradient, and the ladder
    climbs on the drops summed over the ranks, so every rank takes the
    same steps.  The backend is resolved for the frame, not the shard, so
    every rank takes the same backend."""
    backend = resolve_train_backend(backend, scene, cfg)
    mesh = Mesh(0, 1, scene.device) if mesh is None else mesh
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
            loss, grads, info = loss_and_grad_sharded(
                snapshot(), cfg, target_flat, mesh=mesh, backend=backend,
                interleave=interleave, wf_opts=trials[rung], on_drop="ignore",
                return_info=True)
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
