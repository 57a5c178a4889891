"""Inputs that raytpu takes and the port's CUDA backends once refused: a
depth above the dense kernels' stack (MAX_DEPTH), more spheres or lights
than the dense kernels stage (MAX_SPHERES, MAX_LIGHTS), and a pixel
subset to differentiate.  On the CPU:

  * the routing: "auto" on a CUDA scene renders and trains such a scene
    through the wavefront, at any depth, and differentiates a pixel subset
    through the eager tracer (a stand-in scene reports the CUDA device; the
    routing reads only its device and counts);
  * the wavefront's scene check, which bounds neither N nor L;
  * the plain wavefront at depth 9 against the eager tracer, and with
    5000 spheres, under tests/test_wavefront.py:25-36's contract; at depth
    9 also against raytpu's wavefront (the Pallas interpreter) under the
    rule that holds the port to raytpu (tests/test_torch_trace.py): a
    named count of pixels off rtol 1e-5, where XLA's FMA contraction flips
    grazing branches (the same 9 pixels flip at depth 4, where raytpu's
    wavefront and its dense tracer agree), and the forward contract of
    tests/test_pallas.py:19-27 over the frame;
  * a pixel subset's loss and gradient under "auto".

The card's side is tests/test_torch_cuda.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import raytpu.config as jconfig
import raytpu.scene as jscene
import raytpu_torch.config as tconfig
import raytpu_torch.scene as tscene
from raytpu.kernels.wavefront import render_pixels_wavefront as j_render_wavefront
from raytpu_torch.grad import _value_and_grad, image_loss, resolve_train_backend
from raytpu_torch.kernels import trace_cuda
from raytpu_torch.kernels.wavefront import render_pixels_wavefront
from raytpu_torch.render import resolve_backend
from raytpu_torch.scene import scene_leaves
from raytpu_torch.trace import render_image

torch.set_num_threads(2)

CUDA = torch.device("cuda")


@dataclasses.dataclass
class _Count:
    count: int


@dataclasses.dataclass
class _CudaScene:
    """What the routing reads of a scene: its device and its counts."""

    spheres: _Count
    lights: _Count
    device: torch.device = CUDA


def _stub(n=3, nl=2):
    return _CudaScene(_Count(n), _Count(nl))


SMALL = dict(width=64, height=48, alias_factor=1)

# (spheres, lights, depth) beyond a dense bound, each once.
BEYOND = {"depth 9": (3, 2, trace_cuda.MAX_DEPTH + 1),
          "depth 10": (3, 2, 10),
          "5000 spheres at depth 0": (5000, 2, 0),
          "1100 lights": (3, 1100, 2)}


@pytest.mark.parametrize("case", sorted(BEYOND))
def test_render_auto_takes_the_wavefront_beyond_the_dense_bounds(case):
    n, nl, depth = BEYOND[case]
    cfg = tconfig.RenderConfig(max_depth=depth, **SMALL)
    assert resolve_backend("auto", _stub(n, nl), cfg, device=CUDA) == "wavefront"
    # Within the bounds the measured crossover decides, as before.
    assert resolve_backend("auto", _stub(),
                           tconfig.RenderConfig(max_depth=trace_cuda.MAX_DEPTH,
                                                **SMALL), device=CUDA) == "cuda"
    # An explicit backend is kept (its kernel raises on what it does not take).
    assert resolve_backend("cuda", _stub(n, nl), cfg, device=CUDA) == "cuda"


@pytest.mark.parametrize("case", sorted(BEYOND))
def test_training_auto_takes_the_wavefront_beyond_the_dense_bounds(case):
    n, nl, depth = BEYOND[case]
    cfg = tconfig.RenderConfig(max_depth=depth, **SMALL)
    assert resolve_train_backend("auto", _stub(n, nl), cfg) == "wavefront"
    assert resolve_train_backend("auto", _stub(), tconfig.RenderConfig(
        max_depth=trace_cuda.MAX_DEPTH, **SMALL)) == "cuda"


def test_training_auto_with_a_pixel_subset_is_the_eager_tracer():
    cfg = tconfig.RenderConfig(max_depth=2, **SMALL)
    gid = torch.arange(0, cfg.num_pixels, 5)
    for stub in (_stub(), _stub(5000)):
        assert resolve_train_backend("auto", stub, cfg, gid) == "torch"
        assert resolve_train_backend("auto", stub, cfg) != "torch"
    # An explicit backend with a subset is kept, and _render_ad raises on it.
    assert resolve_train_backend("wavefront", _stub(), cfg, gid) == "wavefront"


def test_the_wavefront_scene_check_has_no_upper_bound():
    big = tscene.random_scene(5000, num_lights=1100, seed=1, device="cpu")
    trace_cuda._check_scene(big, big.device, bounded=False)
    with pytest.raises(ValueError, match="4096"):
        trace_cuda._check_scene(big, big.device)
    lit = tscene.random_scene(3, num_lights=1100, seed=1, device="cpu")
    with pytest.raises(ValueError, match="lights"):
        trace_cuda._check_scene(lit, lit.device)
    doubled = dataclasses.replace(big, spheres=dataclasses.replace(
        big.spheres, radius=big.spheres.radius.double()))
    with pytest.raises(TypeError):
        trace_cuda._check_scene(doubled, doubled.device, bounded=False)


def assert_wavefront_contract(out, ref):
    """tests/test_wavefront.py:25-36: outliers at 1e-3*scale <= 0.5%, mean
    abs diff < 1e-4*scale."""
    out, ref = np.asarray(out).reshape(-1, 3), np.asarray(ref).reshape(-1, 3)
    assert out.shape == ref.shape and np.isfinite(out).all()
    scale = max(float(np.abs(ref).max()), 1e-30)
    d = np.abs(out - ref)
    assert (d.max(axis=-1) > 1e-3 * scale).mean() <= 0.005
    assert d.mean() < 1e-4 * scale


def test_plain_wavefront_at_depth_9_matches_eager_and_raytpu():
    kw = dict(width=32, height=24, max_depth=9, alias_factor=1)
    cfg = tconfig.RenderConfig(**kw)
    scene = tscene.default_scene(device="cpu")
    out, info = render_pixels_wavefront(scene, cfg, chunk_rays=1024,
                                        capacity_factor=2, return_info=True)
    assert int(info["dropped"]) == 0
    eager = render_image(scene, cfg).reshape(-1, 3)
    assert_wavefront_contract(out, eager)
    # Depth 9 adds light to a frame of depth 8: the extra level is traced.
    shallow = render_image(scene, tconfig.RenderConfig(**dict(kw, max_depth=8)))
    assert float((eager - shallow.reshape(-1, 3)).abs().max()) > 0
    ref, jinfo = j_render_wavefront(jscene.default_scene(), jconfig.RenderConfig(**kw),
                                    chunk_rays=1024, capacity_factor=2,
                                    interpret=True, return_info=True)
    assert int(jinfo["dropped"]) == 0
    # 13 pixels of the 768 off rtol 1e-5, measured on x86-64; bound +25%.
    out, ref = out.numpy(), np.asarray(ref)
    bad = ~np.isclose(out, ref, rtol=1e-5, atol=1e-10).all(axis=-1)
    assert bad.sum() <= 16, f"{bad.sum()} pixels off rtol 1e-5"
    scale = float(np.abs(ref).max())
    d = np.abs(out - ref)
    assert (d.max(axis=-1) > 1e-2 * scale).mean() <= 0.01
    assert d.mean() < 1e-3 * scale


def test_plain_wavefront_with_5000_spheres_matches_eager():
    scene = tscene.random_scene(5000, seed=3, device="cpu")
    cfg = tconfig.RenderConfig(width=16, height=8, max_depth=2, alias_factor=1)
    out, info = render_pixels_wavefront(scene, cfg, chunk_rays=1024,
                                        capacity_factor=2, return_info=True)
    assert int(info["dropped"]) == 0
    eager = render_image(scene, cfg).reshape(-1, 3)
    assert float(eager.abs().max()) > 0
    assert_wavefront_contract(out, eager)


def test_pixel_subset_loss_and_gradient_under_auto():
    """A strided gid: "auto" renders and differentiates only those pixels,
    and their gradient is the full frame's with the other pixels' residual
    zeroed."""
    scene = tscene.default_scene(device="cpu")
    cfg = tconfig.RenderConfig(width=24, height=16, max_depth=2, alias_factor=1)
    rng = np.random.default_rng(2)
    target = torch.from_numpy(rng.uniform(0, 1e-4, (cfg.num_pixels, 3)).astype(np.float32))
    gid = torch.arange(1, cfg.num_pixels, 3)
    loss, grads = _value_and_grad(lambda s: image_loss(s, cfg, target, gid=gid), scene)
    mask = torch.zeros(cfg.num_pixels, 1)
    mask[gid] = 1.0

    def masked(s):
        err = (render_image(s, cfg).reshape(-1, 3) - target) * mask
        return torch.sum(err * err) / (3 * gid.numel())

    want_loss, want = _value_and_grad(masked, scene)
    torch.testing.assert_close(loss, want_loss, rtol=1e-5, atol=0)
    for a, w in zip(scene_leaves(grads), scene_leaves(want)):
        scale = max(float(w.abs().max()), 1e-30)
        assert float((a - w).abs().max()) <= 1e-5 * scale
    with pytest.raises(ValueError):
        image_loss(scene, cfg, target, gid=gid, backend="wavefront")
