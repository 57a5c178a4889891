"""raytpu's packed-tile training step in the port: the tile layout helpers
(pack_pixel_tiles, unpack_pixel_tiles, tile_mask), render_tiles_cuda_ad
and grad.pack_target / loss_and_grad_packed, on the CPU (the plain
versions) against raytpu's and against the port's flat step.

The port's packed step is its flat step on the unpacked target, so the two
are held at tests/test_grad.py:112-130's tolerances.  Against raytpu
the packed step runs in Pallas interpret mode, as raytpu's own tests run
it, on the single-sphere scene: no pixel of that frame flips a grazing
branch between the two packages (tests/test_torch_grad.py:125-139), so its
gradient is held unmasked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytpu.config as jconfig
import raytpu.grad as jgrad
import raytpu.kernels.trace_pallas as jtp
import raytpu.scene as jscene
import raytpu.trace as jtrace
import raytpu_torch.config as tconfig
import raytpu_torch.grad as tgrad
import raytpu_torch.scene as tscene
from raytpu_torch.kernels import trace_cuda
from raytpu_torch.kernels.trace_cuda import (TILE_PIXELS, pack_pixel_tiles,
                                             render_pixels_cuda_ad,
                                             render_tiles_cuda_ad, tile_mask,
                                             unpack_pixel_tiles)
from raytpu_torch.scene import LEAF_NAMES, scene_leaves
from test_torch_grad import assert_grads_match, masked_cotangent, scenes

torch.set_num_threads(2)


def configs(**kw):
    return jconfig.RenderConfig(**kw), tconfig.RenderConfig(**kw)


def grad_of(fn, scene):
    """The gradient leaves of the scalar fn(scene), as numpy arrays."""
    return [t.numpy() for t in scene_leaves(tgrad._value_and_grad(fn, scene)[1])]


def assert_leaves_close(got, want, rtol, atol):
    for name, a, w in zip(LEAF_NAMES, got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=name)


@pytest.mark.parametrize("width,height", [(40, 6), (32, 32)])
def test_layout_helpers_match_raytpu(width, height):
    """Pack, unpack and the mask bit for bit: 240 pixels (one tile, 784
    tail lanes) and 1024 (exactly one tile)."""
    count = width * height
    rng = np.random.default_rng(width)
    flat = rng.standard_normal((count, 3)).astype(np.float32)
    packed = pack_pixel_tiles(torch.from_numpy(flat))
    want = np.asarray(jtp.pack_pixel_tiles(jnp.asarray(flat)))
    assert packed.shape == want.shape == (3, 8, 128)
    np.testing.assert_array_equal(packed.numpy(), want)
    np.testing.assert_array_equal(
        pack_pixel_tiles(torch.from_numpy(flat), count).numpy(),
        np.asarray(jtp.pack_pixel_tiles(jnp.asarray(flat), count)))

    tbl = rng.standard_normal(want.shape).astype(np.float32)
    np.testing.assert_array_equal(
        unpack_pixel_tiles(torch.from_numpy(tbl), count).numpy(),
        np.asarray(jtp.unpack_pixel_tiles(jnp.asarray(tbl), count)))
    np.testing.assert_array_equal(unpack_pixel_tiles(packed, count).numpy(), flat)

    mask = tile_mask(count, device="cpu")
    assert mask.dtype == torch.float32 and mask.device.type == "cpu"
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jtp.tile_mask(count)))


def test_tile_mask_needs_a_card_unless_told(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device; pass device='cpu'"):
        tile_mask(240)


@pytest.mark.parametrize("width,height", [(40, 6), (32, 32)])
def test_packed_step_matches_the_flat_step(width, height):
    """tests/test_grad.py:112-130 in the port at d2 a2: 40x6 (a tail to
    mask) and 32x32 (one whole tile, no mask)."""
    _, cfg = configs(width=width, height=height, max_depth=2, alias_factor=2)
    scene = tscene.default_scene(device="cpu")
    target = trace_cuda.render_pixels_torch(scene, cfg) * 1.15
    l1, g1 = tgrad.loss_and_grad(scene, cfg, target)
    packed = tgrad.pack_target(cfg, target)
    assert packed.shape == (3, 8, 128)
    l2, g2 = tgrad.loss_and_grad_packed(scene, cfg, packed)
    np.testing.assert_allclose(float(l2), float(l1), rtol=1e-5)
    assert_leaves_close([t.numpy() for t in scene_leaves(g2)],
                        [t.numpy() for t in scene_leaves(g1)], 1e-4, 1e-9)


def test_packed_step_matches_raytpu():
    """Against raytpu.grad.loss_and_grad_pallas_packed in interpret mode,
    on the same seeded target: loss rtol 1e-4, the gradient under the
    contract of tests/test_torch_grad.py."""
    jcfg, tcfg = configs(width=40, height=6, max_depth=2, alias_factor=2)
    js, ts = jscene.single_sphere_scene(), tscene.single_sphere_scene(device="cpu")
    ref = np.asarray(jtrace.render_image(js, jcfg)).reshape(-1, 3)
    rng = np.random.default_rng(3)
    target = (ref * rng.uniform(0.8, 1.3, ref.shape)).astype(np.float32)

    loss_j, grads_j = jgrad.loss_and_grad_pallas_packed(
        js, jcfg, jgrad.pack_target(jcfg, jnp.asarray(target)))
    loss_t, grads_t = tgrad.loss_and_grad_packed(
        ts, tcfg, tgrad.pack_target(tcfg, torch.from_numpy(target)))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    assert_grads_match([t.numpy() for t in scene_leaves(grads_t)],
                       jax.tree_util.tree_leaves(grads_j))


def test_tiled_ad_drops_the_tail_cotangent():
    """tests/test_grad.py:132-150 in the port: the gradient of a plain sum
    over the tiled output is that of the flat output; the tail lanes
    repeat the last pixel."""
    _, cfg = configs(width=40, height=6, max_depth=1, alias_factor=1)
    scene = tscene.default_scene(device="cpu")
    tiles = render_tiles_cuda_ad(scene, cfg).detach()
    flat = render_pixels_cuda_ad(scene, cfg).detach()
    lanes = tiles.reshape(3, -1).T
    assert torch.equal(lanes[:cfg.num_pixels], flat)
    assert torch.equal(lanes[cfg.num_pixels:],
                       flat[-1:].expand(TILE_PIXELS - cfg.num_pixels, 3))
    g1 = grad_of(lambda s: torch.sum(render_tiles_cuda_ad(s, cfg)), scene)
    g2 = grad_of(lambda s: torch.sum(render_pixels_cuda_ad(s, cfg)), scene)
    assert_leaves_close(g1, g2, 1e-5, 1e-10)


@pytest.mark.parametrize("offset,count", [(37, 150), (0, 1024), (100, 1100)])
def test_offset_and_count_match_the_flat_form(offset, count):
    """The pixels offset .. offset+count-1 of a 48x32 frame in whole tiles:
    lane j equals render_pixels_cuda_ad's pixel min(offset + j, P-1) (the
    tail holds the pixels that follow, then repeats the last), and a seeded
    weighting of every lane (the tail's included) has the flat gradient of
    the real lanes' weights."""
    _, cfg = configs(width=48, height=32, max_depth=1, alias_factor=1)
    scene = tscene.default_scene(device="cpu")
    tiles = render_tiles_cuda_ad(scene, cfg, offset, count).detach()
    tiles_n = -(-count // TILE_PIXELS)
    assert tiles.shape == (3, tiles_n * 8, 128)
    lanes = tiles.reshape(3, -1).T
    clamped = render_pixels_cuda_ad(scene, cfg, offset, len(lanes)).detach()
    assert torch.equal(lanes, clamped)

    w = torch.from_numpy(np.random.default_rng(offset).uniform(
        0.5, 1.5, tuple(tiles.shape)).astype(np.float32))
    g1 = grad_of(lambda s: torch.sum(render_tiles_cuda_ad(s, cfg, offset, count)
                                     * w), scene)
    w_flat = unpack_pixel_tiles(w, count)
    g2 = grad_of(lambda s: torch.sum(render_pixels_cuda_ad(s, cfg, offset, count)
                                     * w_flat), scene)
    assert_leaves_close(g1, g2, 1e-5, 1e-10)


@pytest.mark.parametrize("offset,count", [(37, 150), (100, 1100)])
def test_offset_and_count_match_raytpu(offset, count):
    """render_tiles_cuda_ad against raytpu's render_tiles_pallas_ad in
    interpret mode, on the default scene's 48x32 frame: every lane's
    forward (the tail's too: 874 lanes of the pixels that follow, and 612
    that repeat the frame's last pixel) under the forward contract of
    tests/test_torch_grad.py, and the gradient of a seeded weighting of
    every lane, zero where the forwards differ."""
    jcfg, tcfg = configs(width=48, height=32, max_depth=1, alias_factor=1)
    js, ts = scenes("default")
    want = jtp.render_tiles_pallas_ad(js, jcfg, True, offset, count)
    got = render_tiles_cuda_ad(ts, tcfg, offset, count).detach()
    assert got.shape == want.shape
    lanes_t = got.reshape(3, -1).T.numpy()
    lanes_j = np.asarray(want).reshape(3, -1).T
    g, _ = masked_cotangent(lanes_t, lanes_j, seed=offset)
    w = np.ascontiguousarray(g.T).reshape(got.shape)

    _, vjp = jax.vjp(lambda s: jtp.render_tiles_pallas_ad(s, jcfg, True,
                                                          offset, count), js)
    grads_j = jax.tree_util.tree_leaves(vjp(jnp.asarray(w))[0])
    w_t = torch.from_numpy(w)
    grads_t = grad_of(lambda s: torch.sum(
        render_tiles_cuda_ad(s, tcfg, offset, count) * w_t), ts)
    assert_grads_match(grads_t, grads_j)
