"""The port's training path (raytpu_torch.grad, the backward's plain
version, the checkpoint format, the fit example) against raytpu on the CPU.

Gradient contract.  The port and jitted raytpu disagree on a few pixels'
forward values: XLA:CPU contracts multiply-adds into FMAs, which flips a
grazing hit, shadow or Fresnel branch (tests/test_torch_trace.py).  Grazing
hits have near-singular dt/dpos and dominate the position and radius sums,
so every gradient comparison zeroes the cotangent on the pixels whose
forwards differ by more than 1e-5*scale, asserts that they are at most 1% of
the frame, and then holds every leaf at rtol 1e-3 where |ref| > 1e-3*scale
and atol 1e-6*scale elsewhere (the agreement measured on the CPU was
<= 1e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raytpu.config as jconfig
import raytpu.grad as jgrad
import raytpu.scene as jscene
import raytpu.trace as jtrace
import raytpu.utils.checkpoint as jckpt
import raytpu_torch.config as tconfig
import raytpu_torch.grad as tgrad
import raytpu_torch.scene as tscene
from raytpu_torch.examples import fit_scene as fit_example
from raytpu_torch.kernels import trace_cuda
from raytpu_torch.kernels.trace_cuda import (grad_pixels_cuda, grad_pixels_torch,
                                             render_pixels_cuda_ad,
                                             render_pixels_torch)
from raytpu_torch.scene import LEAF_NAMES, scene_leaves
from raytpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

torch.set_num_threads(2)


def scenes(name):
    """(raytpu scene, port scene), bit-identical."""
    if name == "default":
        return jscene.default_scene(), tscene.default_scene()
    return jscene.random_scene(8, seed=3), tscene.random_scene(8, seed=3)


def configs(**kw):
    return jconfig.RenderConfig(**kw), tconfig.RenderConfig(**kw)


def masked_cotangent(port_fwd, ref_fwd, seed=0):
    """Seeded g ~ U(0.5, 1.5), zero on the pixels whose forwards differ by
    more than 1e-5*scale; returns (g, zeroed count)."""
    port_fwd, ref_fwd = np.asarray(port_fwd), np.asarray(ref_fwd)
    scale = max(float(np.abs(ref_fwd).max()), 1e-12)
    bad = np.abs(port_fwd - ref_fwd).max(axis=-1) > 1e-5 * scale
    g = np.random.default_rng(seed).uniform(0.5, 1.5, ref_fwd.shape)
    g = g.astype(np.float32)
    g[bad] = 0.0
    assert bad.mean() <= 0.01, f"{bad.sum()} of {bad.size} pixels differ"
    return g, int(bad.sum())


def assert_grads_match(got, want, rtol=1e-3):
    """Leaf by leaf: rtol where |want| > 1e-3*scale, atol 1e-6*scale else."""
    for name, a, w in zip(LEAF_NAMES, got, want):
        a = np.asarray(a, np.float64).ravel()
        w = np.asarray(w, np.float64).ravel()
        assert np.isfinite(a).all(), name
        scale = max(float(np.abs(w).max()), 1e-30)
        big = np.abs(w) > 1e-3 * scale
        np.testing.assert_allclose(a[big], w[big], rtol=rtol, atol=0,
                                   err_msg=name)
        np.testing.assert_allclose(a[~big], w[~big], rtol=0, atol=1e-6 * scale,
                                   err_msg=name)


def jax_vjp(jscene_, jcfg, gid):
    """raytpu.trace.render_pixels' forward on `gid` and its vjp."""
    return jax.vjp(lambda s: jtrace.render_pixels(s, jcfg, gid), jscene_)


def leaves_np(scene):
    return [t.detach().numpy() for t in scene_leaves(scene)]


@pytest.mark.parametrize("name,width,height", [("default", 32, 32),
                                               ("random8", 32, 16)])
def test_grad_pixels_torch_matches_jax_vjp(name, width, height):
    js, ts = scenes(name)
    jcfg, tcfg = configs(width=width, height=height, max_depth=2, alias_factor=1)
    ref, vjp = jax_vjp(js, jcfg, jnp.arange(jcfg.num_pixels, dtype=jnp.int32))
    g, _ = masked_cotangent(render_pixels_torch(ts, tcfg), ref)
    want = jax.tree_util.tree_leaves(vjp(jnp.asarray(g))[0])
    got = grad_pixels_torch(ts, tcfg, torch.from_numpy(g))
    assert_grads_match(leaves_np(got), want)


def test_offset_stride_count_interface():
    """Pixels {5 + 3j : j < 200} of a 24x16 frame, past its end: the tail
    re-renders pixel P-1 and takes its own cotangent, as the autograd of
    the clamped render does."""
    js, ts = scenes("default")
    jcfg, tcfg = configs(width=24, height=16, max_depth=1, alias_factor=1)
    sel = dict(offset=5, stride=3, count=200)
    gid = np.minimum(5 + 3 * np.arange(200), jcfg.num_pixels - 1)
    ref, vjp = jax_vjp(js, jcfg, jnp.asarray(gid, jnp.int32))
    g, _ = masked_cotangent(render_pixels_torch(ts, tcfg, **sel), ref, seed=1)
    got = grad_pixels_cuda(ts, tcfg, torch.from_numpy(g), **sel)  # CPU: plain
    assert_grads_match(leaves_np(got),
                       jax.tree_util.tree_leaves(vjp(jnp.asarray(g))[0]))
    # The clamped tail: every pixel past the end is P-1, so its cotangents add.
    tail = gid == jcfg.num_pixels - 1
    g_sum = g.copy()
    g_sum[np.argmax(tail)] = g[tail].sum(axis=0)
    g_sum[tail & (np.arange(200) != np.argmax(tail))] = 0.0
    summed = grad_pixels_torch(ts, tcfg, torch.from_numpy(g_sum), **sel)
    for a, b in zip(leaves_np(summed), leaves_np(got)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12)


def test_loss_values_match_raytpu():
    """image_loss, loss_and_grad and exposure_image_loss values (and
    image_loss on a pixel subset) against raytpu's, rtol 1e-4.  The
    single-sphere frame has no pixel whose forward flips between the two
    packages, so loss_and_grad's gradient is held unmasked too."""
    js, ts = jscene.single_sphere_scene(), tscene.single_sphere_scene()
    jcfg, tcfg = configs(width=16, height=12, max_depth=1, alias_factor=1)
    rng = np.random.default_rng(2)
    ref = np.asarray(jtrace.render_image(js, jcfg)).reshape(-1, 3)
    target = (ref * rng.uniform(0.8, 1.3, ref.shape)).astype(np.float32)
    jt, tt = jnp.asarray(target), torch.from_numpy(target)

    loss_j, grads_j = jgrad.loss_and_grad(js, jcfg, jt)
    loss_t, grads_t = tgrad.loss_and_grad(ts, tcfg, tt)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-4)
    assert_grads_match(leaves_np(grads_t), jax.tree_util.tree_leaves(grads_j))
    np.testing.assert_allclose(
        float(tgrad.exposure_image_loss(ts, tcfg, tt / 1e-4)),
        float(jgrad.exposure_image_loss(js, jcfg, jt / 1e-4)), rtol=1e-4)
    gid = rng.choice(tcfg.num_pixels, 40, replace=False)
    np.testing.assert_allclose(
        float(tgrad.image_loss(ts, tcfg, tt, gid=torch.from_numpy(gid))),
        float(jgrad.image_loss(js, jcfg, jt, gid=jnp.asarray(gid, jnp.int32))),
        rtol=1e-4)


def test_finite_difference_check_rows_on_colour_leaves():
    """Same rows as raytpu's checker; on the colour leaves the analytic
    column matches raytpu's (rtol 1e-3) and the numeric one (10%, as
    tests/test_grad.py)."""
    cfg_kw = dict(width=8, height=8, max_depth=1, alias_factor=1)
    jcfg, tcfg = configs(**cfg_kw)
    js, ts = jscene.single_sphere_scene(), tscene.single_sphere_scene()
    target = np.asarray(jtrace.render_image(js, jcfg)).reshape(-1, 3) * 0.7
    rows_j = jgrad.finite_difference_check(
        jax.jit(lambda s: jgrad.image_loss(s, jcfg, jnp.asarray(target))), js,
        eps=1e-3, max_coords=2)
    rows_t = tgrad.finite_difference_check(
        lambda s: tgrad.image_loss(s, tcfg, torch.from_numpy(target)), ts,
        eps=1e-3, max_coords=2)
    assert [r[:2] for r in rows_t] == [r[:2] for r in rows_j]
    colour = {LEAF_NAMES.index(n) for n in ("spheres.matte", "lights.col")}
    checked = 0
    for (li, _, a_t, n_t), (_, _, a_j, _) in zip(rows_t, rows_j):
        if li in colour and abs(a_j) > 1e-12:
            np.testing.assert_allclose(a_t, a_j, rtol=1e-3)
            assert abs(a_t - n_t) <= 0.1 * abs(n_t) + 1e-9
            checked += 1
    assert checked >= 3


def test_fit_scene_lowers_the_loss_and_steps_like_optax():
    """Three CPU steps lower the loss; the first step is optax.adam's on the
    port's gradient (rtol 1e-5), with untrained leaves left as they were."""
    _, ts = scenes("default")
    tcfg = tconfig.RenderConfig(width=16, height=12, max_depth=1, alias_factor=1)
    target = render_pixels_torch(ts, tcfg)
    start = fit_example.perturb(ts, geometry=False)
    trainable = tscene.scene_from_leaves(
        [n in ("spheres.matte", "lights.col") for n in LEAF_NAMES])
    opt = lambda p: torch.optim.Adam(p, lr=2e-2, eps=1e-16)  # noqa: E731
    fitted, losses = tgrad.fit_scene(start, tcfg, target, steps=3,
                                     trainable=trainable, optimizer=opt)
    assert len(losses) == 3 and losses[-1] < losses[0]

    optax = pytest.importorskip("optax")
    one, _ = tgrad.fit_scene(start, tcfg, target, steps=1, trainable=trainable,
                             optimizer=opt)
    _, grads = tgrad.loss_and_grad(start, tcfg, target)
    params = leaves_np(start)
    g = [x.numpy() if m else np.zeros_like(x.numpy())
         for x, m in zip(scene_leaves(grads), scene_leaves(trainable))]
    tx = optax.adam(2e-2, eps=1e-16)
    updates, _ = tx.update(g, tx.init(params), params)
    want = optax.apply_updates(params, updates)
    for name, a, w, p, m in zip(LEAF_NAMES, leaves_np(one), want, params,
                                scene_leaves(trainable)):
        np.testing.assert_allclose(a, np.asarray(w), rtol=1e-5, err_msg=name)
        if not m:
            np.testing.assert_array_equal(a, p, err_msg=name)


def test_checkpoints_cross_between_packages(tmp_path):
    js, ts = scenes("random8")
    moved = dataclasses.replace(
        ts, spheres=dataclasses.replace(ts.spheres, pos=ts.spheres.pos + 0.5))
    a, b = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_checkpoint(a, moved)
    from_port = jckpt.load_checkpoint(a, js)
    for x, y in zip(jax.tree_util.tree_leaves(from_port), leaves_np(moved)):
        np.testing.assert_array_equal(np.asarray(x), y)
    jckpt.save_checkpoint(b, from_port)
    back = load_checkpoint(b, ts)
    for x, y in zip(leaves_np(back), leaves_np(moved)):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError):
        load_checkpoint(a, tscene.default_scene())


def test_render_pixels_fn_on_the_cpu_is_plain_autograd():
    """On a CPU scene the autograd Function's backward is the plain version,
    and gives exactly the gradient of autograd through the eager tracer."""
    ts = tscene.random_scene(5, seed=4)
    cfg = tconfig.RenderConfig(width=12, height=10, max_depth=2, alias_factor=2)
    g = torch.from_numpy(np.random.default_rng(5).uniform(
        0.5, 1.5, (cfg.num_pixels, 3)).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in scene_leaves(ts)]
    s = tscene.scene_from_leaves(leaves)
    before = trace_cuda.TRACE_BWD.launches
    via_fn = torch.autograd.grad(torch.sum(render_pixels_cuda_ad(s, cfg) * g),
                                 leaves, allow_unused=True)
    direct = torch.autograd.grad(torch.sum(render_pixels_torch(s, cfg) * g),
                                 leaves, allow_unused=True)
    assert trace_cuda.TRACE_BWD.launches == before
    for name, a, b in zip(LEAF_NAMES, via_fn, direct):
        b = torch.zeros_like(a) if b is None else b
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def test_unported_training_paths_name_the_roadmap():
    _, ts = scenes("default")
    cfg = tconfig.RenderConfig(width=8, height=4, max_depth=0, alias_factor=1)
    target = torch.zeros(cfg.num_pixels, 3)
    for kw in (dict(mesh=object()), dict(interleave=True),
               dict(mesh=object(), backend="wavefront"),
               dict(interleave=True, wf_opts={})):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tgrad.fit_scene(ts, cfg, target, steps=1, **kw)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tgrad.loss_and_grad_sharded(ts, cfg, target)
    with pytest.raises(ValueError):
        tgrad.loss_and_grad(ts, cfg, target, backend="cuda")  # CPU scene
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        fit_example.main(["--cpu", "--mesh", "2"])


def test_fit_example_runs_on_the_cpu_only_when_asked(capsys):
    res = fit_example.main(["--cpu", "--steps", "3", "--width", "16",
                            "--height", "12", "--depth", "1"])
    assert len(res["losses"]) == 3 and res["losses"][-1] < res["start_loss"]
    assert res["fitted"].device.type == "cpu"
    assert "loss:" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit) as exc:
            fit_example.main(["--steps", "1"])
        assert exc.value.code == 2
        assert "no CUDA device" in capsys.readouterr().err
