"""The port's sharded paths (raytpu_torch.parallel, render_sharded,
loss_and_grad_sharded, fit_scene(mesh=), the CLI's --sharded) over two
gloo ranks on the CPU, against the port's one-device results and against
raytpu's sharded render and gradient on a 2-device CPU mesh.

One module-scoped spawn of raytpu_torch.tools.multiprocess_demo's "cpu"
suite over 2 processes (plain versions, tiny frames, a time limit of its
own); each case is a parametrized test over its results.  The
contracts: a sharded frame is the one-device frame bit for bit (pixels are
independent, and a pixel's rays are summed in one order whatever its
set); a sharded loss within rtol 1e-5 and every gradient leaf within 2e-3 x
max |one-device| (the ranks' shares add in another order); the fit's
replicas bit-identical; against raytpu, the forward contract of
tests/test_pallas.py:19-27 and the gradient contract of :304-314.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import raytpu.config as jconfig
import raytpu.grad as jgrad
import raytpu.render as jrender
import raytpu.scene as jscene
import raytpu.trace as jtrace
from raytpu.parallel.mesh import make_mesh as jax_mesh
from raytpu_torch.config import RenderConfig
from raytpu_torch.grad import fit_scene, loss_and_grad_sharded
from raytpu_torch.parallel import (Mesh, initialize_distributed, make_mesh,
                                   pixel_set)
from raytpu_torch.parallel.mesh import interleaved
from raytpu_torch.scene import LEAF_NAMES, default_scene, scene_leaves
from raytpu_torch.tools import multiprocess_demo as demo
from raytpu_torch.trace import render_image
from raytpu_torch.utils.profiling import counters, reset

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = {c["name"]: c for c in demo.SUITES["cpu"]}
RENDER = [n for n, c in CASES.items() if c["kind"] == "render"]
GRAD = [n for n, c in CASES.items() if c["kind"] == "grad"]
FIT = [n for n, c in CASES.items() if c["kind"] == "fit"]


@pytest.fixture(scope="module")
def targets():
    """Each gradient case's targets for (the port, raytpu): half the port's
    frame, except on the pixels whose forwards differ by more than
    1e-5*scale (jitted raytpu contracts FMAs; tests/test_torch_grad.py),
    where each target is that package's own frame, so that those pixels
    take no cotangent in either."""
    out = {}
    for name in GRAD:
        case = CASES[name]
        port = render_image(default_scene(device="cpu"), RenderConfig(
            **dict(zip(("width", "height", "max_depth", "alias_factor"),
                       case["cfg"])))).reshape(-1, 3).numpy()
        ref = np.asarray(jtrace.render_image(jscene.default_scene(),
                                             jax_config(case))).reshape(-1, 3)
        scale = float(np.abs(ref).max())
        bad = np.abs(port - ref).max(axis=-1) > 1e-5 * scale
        assert bad.mean() <= 0.05, f"{bad.sum()} of {bad.size} pixels differ"
        t_port, t_ref = 0.5 * port, 0.5 * port
        t_port[bad], t_ref[bad] = port[bad], ref[bad]
        out[name] = (t_port, t_ref)
    return out


@pytest.fixture(scope="module")
def results(tmp_path_factory, targets):
    return demo.spawn("cpu", procs=2, out_dir=str(tmp_path_factory.mktemp("mp")),
                      timeout=120, targets={k: v[0] for k, v in targets.items()})


def jax_config(case):
    w, h, d, a = case["cfg"]
    return jconfig.RenderConfig(width=w, height=h, max_depth=d, alias_factor=a)


def test_pixel_sets_cover_the_frame_once():
    """Every rank's set, block, interleaved or the default, clamped to P-1:
    together exactly the frame's pixels, each once outside the repeated
    tail."""
    for p in (1, 7, 91, 96):
        cfg = RenderConfig(width=p, height=1)
        for n in (1, 2, 3, 4):
            for interleave in (False, True, None):
                ids = []
                for r in range(n):
                    offset, count, stride = pixel_set(Mesh(r, n, "cpu"), cfg,
                                                      interleave)
                    assert count == -(-p // n)
                    ids += [min(offset + j * stride, p - 1) for j in range(count)]
                assert sorted(set(ids)) == list(range(p))
                assert len(ids) - len(set(ids)) == n * count - p


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_pixel_set_interleaves_by_default_on_more_than_one_rank(n):
    """interleave None: the strided set (rank, per, size) on a mesh of 2 to
    4 ranks and (0, P, 1) on a world of one; an explicit False gives the
    block and True the strided set, as before the default changed."""
    cfg = RenderConfig(width=24, height=16)
    per = -(-cfg.num_pixels // n)
    for r in range(n):
        mesh = Mesh(r, n, "cpu")
        assert pixel_set(mesh, cfg) == pixel_set(mesh, cfg, None)
        assert pixel_set(mesh, cfg) == ((r, per, n) if n > 1 else (0, per, 1))
        assert pixel_set(mesh, cfg, False) == (r * per, per, 1)
        assert pixel_set(mesh, cfg, True) == (r, per, n)
        assert interleaved(mesh) is (n > 1)
        assert interleaved(mesh, False) is False and interleaved(mesh, True) is True


def test_the_interleaved_sets_are_counted_on_more_than_one_rank():
    """mesh.interleaved adds one a pixel_set call that returns an
    interleaved set over more than one rank, while a profiler records; a
    world of one, a block and a call outside a profiler add nothing."""
    cfg = RenderConfig(width=6, height=4)
    reset()
    try:
        pixel_set(Mesh(1, 2, "cpu"), cfg)
        assert "mesh.interleaved" not in counters()
        with profile(activities=[ProfilerActivity.CPU]):
            pixel_set(Mesh(0, 1, "cpu"), cfg)
            pixel_set(Mesh(0, 1, "cpu"), cfg, True)
            pixel_set(Mesh(2, 3, "cpu"), cfg, False)
            assert "mesh.interleaved" not in counters()
            pixel_set(Mesh(1, 2, "cpu"), cfg)
            assert counters()["mesh.interleaved"] == 1
            pixel_set(Mesh(3, 4, "cpu"), cfg)
            pixel_set(Mesh(0, 3, "cpu"), cfg, True)
        assert counters()["mesh.interleaved"] == 3
    finally:
        reset()


def test_a_fit_over_a_world_of_one_is_the_same_in_either_layout():
    """fit_scene over a world of one: the default layout and an explicit
    interleave=False give bit-identical losses and scenes."""
    scene = default_scene(device="cpu")
    cfg = RenderConfig(width=12, height=8, max_depth=1, alias_factor=1)
    target = torch.rand(cfg.num_pixels, 3,
                        generator=torch.Generator().manual_seed(5)) * 1e-4
    fits = [fit_scene(scene, cfg, target, steps=2, mesh=make_mesh("cpu"),
                      backend="wavefront", wf_opts={"chunk_rays": 64},
                      **kw) for kw in ({}, {"interleave": False})]
    (a, la), (b, lb) = fits
    assert la == lb and len(la) == 2
    for x, y in zip(scene_leaves(a), scene_leaves(b)):
        assert torch.equal(x, y)


def test_world_of_one_without_a_process_group():
    mesh = make_mesh("cpu")
    assert (mesh.rank, mesh.size, mesh.group, mesh.backend) == (0, 1, None, None)
    assert initialize_distributed(None) is None  # no coordinator: a no-op
    cfg = RenderConfig(width=5, height=3, max_depth=0, alias_factor=1)
    with pytest.raises(ValueError, match="divide"):
        loss_and_grad_sharded(default_scene(device="cpu"), cfg, torch.zeros(15, 3),
                              Mesh(0, 2, torch.device("cpu")))


def test_demo_runs_on_the_card_unless_asked_for_the_cpu(monkeypatch, capsys):
    """Without --cpu the demo takes its card suite on cuda:0, and without a
    card it exits 2 before it starts a worker."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(demo, "spawn", lambda *a, **k: pytest.fail("spawned"))
    assert demo.main([]) == 2
    assert "--cpu" in capsys.readouterr().err


@pytest.mark.parametrize("name", RENDER)
def test_sharded_render_is_the_one_device_frame(results, name):
    s = demo.case_summary(results, CASES[name])
    assert s["ranks_agree"] and s["dropped"] == 0
    assert s["max_abs_err"] <= 1e-6 * s["scale"], s
    assert s["bit_identical"], s


@pytest.mark.parametrize("name", RENDER)
def test_sharded_render_matches_raytpu_sharded(results, name):
    case = CASES[name]
    want = np.asarray(jrender.render_sharded(
        jscene.default_scene(), jax_config(case), jax_mesh(jax.devices()[:2]),
        backend="jnp", interleave=case["interleave"]))
    got = results[0][f"{name}/image"]
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-12)
    d = np.abs(got - want)
    assert (d.max(axis=-1) > 1e-2 * scale).mean() <= 0.01
    assert d.mean() < 1e-3 * scale


@pytest.mark.parametrize("name", GRAD)
def test_sharded_gradient_is_the_one_device_gradient(results, name):
    s = demo.case_summary(results, CASES[name])
    assert s["ranks_agree"] and s["dropped"] == 0
    assert s["loss_rel_err"] <= 1e-5, s
    assert s["grad_rel_err"] <= 2e-3, s


@pytest.mark.parametrize("name", GRAD)
def test_sharded_gradient_matches_raytpu_sharded(results, targets, name):
    case, r0 = CASES[name], results[0]
    loss, grads = jgrad.loss_and_grad_sharded(
        jscene.default_scene(), jax_config(case), jnp.asarray(targets[name][1]),
        jax_mesh(jax.devices()[:2]), backend="jnp",
        interleave=case["interleave"] is not False)  # None: 2 ranks interleave
    np.testing.assert_allclose(float(r0[f"{name}/loss"]), float(loss), rtol=1e-4)
    for leaf, b in zip(LEAF_NAMES, jax.tree_util.tree_leaves(grads)):
        a, b = r0[f"{name}/grad/{leaf}"], np.asarray(b)
        scale = max(np.abs(b).max(), 1e-12)
        mask = np.abs(b) > 1e-3 * scale
        np.testing.assert_allclose(a[mask], b[mask], rtol=5e-2, atol=1e-12,
                                   err_msg=leaf)


@pytest.mark.parametrize("name", FIT)
def test_sharded_fit_keeps_the_replicas_identical(results, name):
    s = demo.case_summary(results, CASES[name])
    assert s["ranks_agree"], "the ranks' fitted scenes differ"
    assert len(s["losses"]) == CASES[name]["steps"]
    assert s["loss_rel_err"] <= 1e-5, s


def test_the_default_layout_gradient_is_the_interleaved_one(results):
    """Over 2 ranks the default layout takes the interleaved sets: its loss
    and gradient are the interleaved case's bit for bit on every rank, and
    the block case's within the gradient contract (loss rtol 1e-5, every
    leaf within 2e-3 x max |block|: the ranks' shares add in another
    order)."""
    get = lambda r, case, key: r[f"grad_wavefront_{case}/{key}"]  # noqa: E731
    keys = ["loss", "dropped"] + [f"grad/{leaf}" for leaf in LEAF_NAMES]
    for r in results:
        for key in keys:
            assert np.array_equal(get(r, "default", key),
                                  get(r, "interleave", key)), key
    r0 = results[0]
    loss, block = float(get(r0, "default", "loss")), float(get(r0, "block", "loss"))
    assert abs(loss - block) <= 1e-5 * abs(block)
    for leaf in LEAF_NAMES:
        a, b = get(r0, "default", f"grad/{leaf}"), get(r0, "block", f"grad/{leaf}")
        assert np.abs(a - b).max() <= 2e-3 * max(np.abs(b).max(), 1e-30), leaf


def test_a_drop_on_one_rank_raises_on_every_rank(results):
    s = demo.case_summary(results, CASES["drop"])
    assert s["local_dropped"][0] == 0 and s["local_dropped"][1] > 0, s
    assert s["raised"] == {"render": [True, True], "grad": [True, True]}, s


@pytest.mark.parametrize("module,args", [
    ("raytpu_torch.cli", ["--sharded", "--interleave", "--width", "33",
                          "--height", "17", "--max-depth", "2",
                          "--alias-factor", "1", "-o", "{out}"]),
    ("raytpu_torch.examples.fit_scene", ["--mesh", "2", "--steps", "2",
                                         "--width", "16", "--height", "12",
                                         "--depth", "1"]),
])
def test_entry_points_under_torchrun(tmp_path, module, args):
    """The CLI's --sharded --interleave and the fit example's --mesh 2 over
    2 gloo ranks that torchrun starts: the CLI's PPM is the one-device
    render's, byte for byte; the fit runs and rank 0 alone reports."""
    out = str(tmp_path / "sharded.ppm")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", module, "--cpu"]
    cmd += [a.format(out=out) for a in args]
    res = subprocess.run(cmd, cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    if module == "raytpu_torch.cli":
        one = str(tmp_path / "one.ppm")
        single = [a.format(out=one) for a in args if a not in ("--sharded",
                                                               "--interleave")]
        subprocess.run([sys.executable, "-m", module, "--cpu"] + single,
                       cwd=str(tmp_path), env=env, check=True, timeout=120)
        with open(out, "rb") as f, open(one, "rb") as g:
            assert f.read() == g.read()
        assert res.stdout.count("wrote") == 1
    else:
        assert res.stdout.count("loss:") == 1
